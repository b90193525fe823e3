"""Device operations per physics substep in the profiled sub-window (every
kernel, copy and fill the trace shows, the task's and, in a training step,
the learner's included)."""

from benchmark import readers


def read(ctx):
  return readers.ops_per_substep(ctx)

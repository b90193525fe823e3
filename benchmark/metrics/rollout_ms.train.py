"""Host-clock ms of a training step's rollout (`PPO._unroll`, the env and
its auto-reset under it), between synchronizes; the window's median."""

from benchmark import readers


def read(ctx):
  return readers.span_ms(ctx, "rollout")

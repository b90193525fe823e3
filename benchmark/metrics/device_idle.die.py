"""Share of the profiled sub-window's wall in which no operation ran on
the device: 1 - (union of the operations' intervals) / wall, in %."""

from benchmark import readers


def read(ctx):
  return readers.idle_pct(ctx)

"""Host-clock ms of a training step's update (`PPO._update_epoch`: GAE and
every minibatch step), between synchronizes; the window's median."""

from benchmark import readers


def read(ctx):
  return readers.span_ms(ctx, "update")

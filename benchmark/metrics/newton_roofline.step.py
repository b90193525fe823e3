"""The Newton kernel's share of its roofline at solver inputs captured in
the window, timed alone after it by CUDA events (`readers.
newton_roofline_pct`), in %."""

from benchmark import readers


def install(ctx):
  readers.install_newton(ctx)


def read(ctx):
  return readers.newton_roofline_pct(ctx)

"""Milliseconds of one call of `collision.collision` (one substep's contact
detection for the whole batch), at a state captured in the window, timed
alone after it by CUDA events over 20 calls."""

from benchmark import readers, tracing

MOD = "myosuite_tpu_torch.physics.collision"


def install(ctx):
  readers.capture(ctx, MOD, "collision", "collision", clone=False)


def read(ctx):
  if "collision" not in ctx.captures:
    return None
  fn, args, kw = ctx.captures["collision"]
  return tracing.cuda_ms(lambda: fn(*args, **kw), 20, ctx.device)

"""What the per-layer metrics' readers share. A reader module
`metrics/<name>.py` defines `read(ctx)`, which returns the metric's value
or None where the run gave it nothing to read, and may define
`install(ctx)`, called after set-up and before the window, to capture the
inputs of one call of a layer during the window. `ctx` is
`harness.Context`."""

from __future__ import annotations

import statistics
import sys
from typing import Optional

from benchmark import costs, tracing

CAPTURE_AT = 5   # the call of the window whose inputs a capture keeps


def span_ms(ctx, name: str) -> Optional[float]:
  """Median milliseconds of the window's spans `name`."""
  vals = ctx.spans.seconds.get(name) if ctx.spans else None
  return 1e3 * statistics.median(vals) if vals else None


def ops_per_substep(ctx) -> Optional[float]:
  """Device operations of the profiled sub-window per physics substep."""
  if ctx.profile is None or not ctx.profiled_substeps or not ctx.profile.ops:
    return None
  return ctx.profile.n_ops / ctx.profiled_substeps


def idle_pct(ctx) -> Optional[float]:
  """Share of the profiled sub-window's wall in which no operation ran on
  the device, in %."""
  if ctx.profile is None or not ctx.profile.ops or ctx.profile.wall_s <= 0:
    return None
  return 100.0 * (1.0 - ctx.profile.busy_s() / ctx.profile.wall_s)


def capture(ctx, modname: str, attr: str, key: str, clone: bool) -> None:
  """Keep the arguments of the CAPTURE_AT-th call of `modname.attr` in
  ctx.captures[key] (cloned tensors where `clone`)."""
  import torch
  mod = sys.modules[modname]
  fn = getattr(mod, attr)
  calls = [0]

  def capturing(*args, **kw):
    calls[0] += 1
    if calls[0] == CAPTURE_AT:
      keep = lambda x: x.clone() if clone and isinstance(x, torch.Tensor) \
          else x
      ctx.captures[key] = (fn, tuple(keep(a) for a in args), dict(kw))
    return fn(*args, **kw)

  setattr(mod, attr, capturing)
  ctx.undo.append(lambda: setattr(mod, attr, fn))


NEWTON = "myosuite_tpu_torch.physics.newton_kernel"


def install_newton(ctx) -> None:
  """Capture the Newton launch's inputs (once, whichever reader asks)."""
  if "newton_capture" not in ctx.captures:
    ctx.captures["newton_capture"] = True
    capture(ctx, NEWTON, "newton_solve", "newton", clone=True)


def newton_cost(ctx) -> Optional[dict]:
  """The Newton launch at inputs captured in the window, timed alone by
  CUDA events (`ms`), with its operations, bytes and least time
  (`costs.bound_seconds`) at the launch's shapes, the configuration's
  iteration counts and the rows its solution weights; once per run."""
  if "newton_cost" in ctx.captures:
    return ctx.captures["newton_cost"]
  if "newton" not in ctx.captures:
    return None
  fn, args, kw = ctx.captures["newton"]
  ms = tracing.cuda_ms(lambda: fn(*args, **kw), 20, ctx.device)
  qM, J = args[0], args[1]
  force = fn(*args, **kw)[2]
  bound_s, ops, nbytes = costs.bound_seconds(
      qM.shape[0], qM.shape[1], J.shape[1], kw["iterations"],
      kw["ls_iterations"], costs.weighted_rows(force, kw["n_friction"]))
  out = {"ms": ms, "ops": ops, "bytes": nbytes, "bound_ms": 1e3 * bound_s}
  print(f"newton launch: {ms} ms at B {qM.shape[0]}, nv {qM.shape[1]}, "
        f"nefc {J.shape[1]}; {ops:.6e} ops, {nbytes:.6e} bytes, bound "
        f"{1e3 * bound_s:.6f} ms", file=sys.stderr)
  ctx.captures["newton_cost"] = out
  return out


def newton_roofline_pct(ctx) -> Optional[float]:
  """Share of its roofline that the Newton launch reaches (`newton_cost`),
  in %."""
  c = newton_cost(ctx)
  if c is None or c["ms"] is None:
    return None
  return 100.0 * c["bound_ms"] / c["ms"]

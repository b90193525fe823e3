"""One run of a cell: set-up, the measured window, the traced sub-window,
the per-layer readers and the output check.

The traffic mix's `kind` names the module that drives the window
(`kinds/<kind>.py`: `drive`, and `RATE`, the name under which a cell
that lists it reports the window's env-steps per second);
everything else about the traffic (batch, rollout length, the PPO
settings, the rows the check samples) is read from the traffic file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark import check, tracing
from benchmark.spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "myosuite_tpu")


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name, compared whole, is JAX's, flax's
  or the JAX package's."""
  return sorted({k.split(".")[0] for k in list(sys.modules)}
                & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
  """What a per-layer metric's reader reads: spans, the profiled
  sub-window, and what its `install` captured during the window."""
  device: torch.device
  cell: Cell
  env: Any = None
  trainer: Any = None
  spans: Optional[tracing.Spans] = None
  profile: Optional[tracing.Profile] = None
  profiled_substeps: int = 0
  captures: Dict[str, Any] = dataclasses.field(default_factory=dict)
  undo: List[Callable[[], None]] = dataclasses.field(default_factory=list)
  mesh: Any = None              # the program's mesh of ranks, or None
  window: Any = None            # the measured window's `Window`
  marks: List[Any] = dataclasses.field(default_factory=list)  # set-up parts

  def mark(self, part: str) -> None:
    """The end of a part of set-up, on the host clock after a sync."""
    tracing.sync(self.device)
    self.marks.append((part, time.perf_counter()))

  @property
  def rank0(self) -> bool:
    return self.mesh is None or self.mesh.rank == 0


@dataclasses.dataclass
class Window:
  setup_s: float = 0.0
  window_s: float = 0.0
  env_steps: int = 0           # env-steps completed in the window
  step_ms: List[float] = dataclasses.field(default_factory=list)
  attempted: int = 0
  failed: int = 0
  record: Dict[str, Any] = dataclasses.field(default_factory=dict)


# the program's stage functions that the traced run names as host spans
STAGES = {
    "myosuite_tpu_torch.physics.forward": (
        "fwd_position", "fwd_velocity", "fwd_actuation", "fwd_acceleration",
        "fwd_constraint", "euler"),
    "myosuite_tpu_torch.physics.collision": ("collision",),
    "myosuite_tpu_torch.physics.constraint": ("make_efc",),
    "myosuite_tpu_torch.physics.solver": ("solve",),
}
ENV_HOOKS = ("_get_obs", "_get_rewards", "_get_done", "_get_info")


def span_stages(ctx: Context, env) -> None:
  """Name each physics stage and env hook as a host span."""
  for modname, names in STAGES.items():
    mod = sys.modules[modname]
    for n in names:
      ctx.undo.append(tracing.wrap_span(mod, n, n))
  env = getattr(env, "_env", env)   # under the auto-reset wrapper
  for n in ENV_HOOKS:
    ctx.undo.append(tracing.wrap_span(env, n, "env" + n))


def _device_info(device: torch.device, count: int) -> Dict[str, Any]:
  if device.type != "cuda":
    return {"platform": device.type, "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}
  return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
          "count": count,
          "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def install_readers(ctx: Context) -> None:
  """Open the traced run's spans and let each reader capture what it
  needs from the window, before the window."""
  ctx.spans = tracing.Spans(ctx.device)
  for reader in ctx.captures.pop("_readers", []):
    if hasattr(reader, "install"):
      reader.install(ctx)


@contextlib.contextmanager
def patched(owner, attr: str, new):
  """`owner.attr` (of a class or a module) replaced by `new` inside."""
  old = owner.__dict__[attr]
  setattr(owner, attr, new)
  try:
    yield
  finally:
    setattr(owner, attr, old)


# -- the run ------------------------------------------------------------------

def end_to_end(win: Window, rate: str,
               device: Dict[str, Any]) -> Dict[str, float]:
  """Every end-to-end number a run can give; the cell reports those that
  BENCHMARK.json lists for it. `rate` is the traffic kind's name for the
  window's env-steps per second, `device` the result line's `device`."""
  out = {"setup_s": win.setup_s, rate: win.env_steps / win.window_s}
  if len(win.step_ms) >= 10:
    out["step_ms_p90"] = statistics.quantiles(win.step_ms, n=10)[-1]
  if device["memory_peak_bytes"]:
    out["memory_peak_gb"] = device["memory_peak_bytes"] / 1e9
  return out


def format_result(correct: bool, attempted: int, failed: int,
                  metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                  checked: Dict[str, Dict[str, float]],
                  breakdown: Optional[Dict[str, Any]] = None) -> str:
  """The result line; the numbers compared come last."""
  out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                         "failed": int(failed), "metrics": metrics,
                         "device": device}
  if breakdown is not None:
    out["breakdown"] = breakdown
  out["checked"] = checked
  return json.dumps(out)


def join_mesh(device: torch.device, rank: int, world: int, init: str):
  """This process's rank of the program's mesh over `world` cards, joined
  at the rendezvous `init` (NCCL; gloo on the CPU, for the tests)."""
  from myosuite_tpu_torch.parallel import mesh as mesh_mod
  mesh_mod.initialize_distributed(
      backend="nccl" if device.type == "cuda" else "gloo", init_method=init,
                                  world_size=world, rank=rank,
                                  device=device)
  return mesh_mod.make_mesh(device)


def _reduce(x: float, mesh, op) -> float:
  """`x` reduced over the ranks by `op`."""
  if mesh is None:
    return x
  t = torch.tensor([float(x)], dtype=torch.float64, device=mesh.device)
  torch.distributed.all_reduce(t, op=op)
  return float(t)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr),
        rank: int = 0, init: Optional[str] = None) -> Optional[str]:
  """One run of `cell`; returns the result line (on every rank but 0 of a
  cell over several ranks, ""), or None where a module of JAX or of the JAX
  package was loaded. A cell whose traffic names `ranks` runs as `rank` of
  them, joined at the rendezvous `init`."""
  ctx = Context(device=device, cell=cell)
  if device.type == "cuda":
    torch.cuda.init()
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
  ctx.marks.append(("import", t0))
  ctx.mark("torch import and CUDA init")
  world = int(cell.traffic.get("ranks", 1))
  if world > 1:
    ctx.mesh = join_mesh(device, rank, world, init)
    ctx.mark("rank join")
  readers = ({m.name: m.reader() for m in cell.per_layer}
             if trace and ctx.rank0 else {})
  ctx.captures["_readers"] = list(readers.values())
  win = cell.kind.drive(cell, seed, seconds, trace, device, t0, ctx)
  ctx.window = win
  dev = _device_info(device, cell.chips)
  if ctx.mesh is not None:
    dev["memory_peak_bytes"] = int(_reduce(
        dev["memory_peak_bytes"], ctx.mesh, torch.distributed.ReduceOp.MAX))
  units = {m.name: m.unit for m in cell.end_to_end + cell.per_layer}
  metrics: Dict[str, Dict[str, Any]] = {}
  breakdown = None
  if trace:
    for name, reader in readers.items():
      value = reader.read(ctx)
      if value is not None:
        metrics[name] = {"value": float(value), "unit": units[name]}
    busy = ctx.profile.busy_s()
    log(f"traced sub-window: {ctx.profile.wall_s:.4f} s wall, {busy:.4f} s "
        f"device busy, {ctx.profile.n_ops} device operations, "
        f"{ctx.profiled_substeps} substeps")
    breakdown = {"device_ops": ctx.profile.device_ops(),
                 "idle_gaps": ctx.profile.idle_gaps()}
    # averaged over the cards
    dev["busy_s"] = _reduce(busy, ctx.mesh,
                            torch.distributed.ReduceOp.SUM) / world
    dev["window_s"] = ctx.profile.wall_s
  else:
    for name, value in end_to_end(win, cell.kind.RATE, dev).items():
      if name in units:
        metrics[name] = {"value": value, "unit": units[name]}
  log("set-up parts: " + ", ".join(
      f"{part} {b - a:.3f} s" for (_, a), (part, b) in
      zip(ctx.marks, ctx.marks[1:])))
  log(f"window: {win.window_s:.4f} s, {win.env_steps} env-steps, "
      f"{win.env_steps / win.window_s:.4f} env-steps/s, set-up "
      f"{win.setup_s:.4f} s, memory peak {dev['memory_peak_bytes']} bytes"
      + (f", step ms median {statistics.median(win.step_ms):.4f}"
         if win.step_ms else ""))
  found = forbidden_modules()
  if found:
    log(f"loaded after the window: {', '.join(found)}")
    return None
  for undo in reversed(ctx.undo):
    undo()
  # the program's state is freed before the reference runs
  ctx.env = ctx.trainer = ctx.profile = ctx.window = None
  ctx.captures.clear()
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()
  t_ref = time.perf_counter()
  gaps = check.compare(cell, seed, device, win.record, ctx.mesh)
  log(f"reference: {time.perf_counter() - t_ref:.4f} s")
  if not ctx.rank0:
    return ""
  checked = {k: {"value": v, "limit": cell.limits[k]}
             for k, v in gaps.items()}
  correct = all(v <= cell.limits[k] for k, v in gaps.items())
  for k, c in checked.items():
    log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
  found = forbidden_modules()
  if found:
    log(f"loaded: {', '.join(found)}")
    return None
  return format_result(correct, win.attempted, win.failed, metrics, dev,
                       checked, breakdown)

"""The "ppo" traffic kind: PPO training steps in a closed loop.

Set-up builds the trainer from the seed and drives it through its first
`check_steps` training steps, which the check holds against the
reference; the window goes on with the same object. A traffic that names
`ranks` runs data-parallel PPO over that many cards, one process each,
through the program's mesh (`parallel/mesh.py`); rank 0 reports.

The check: the reference builds its trainer from the same seed and
follows the program's first `check_steps` training steps. `loss_gap` is
the widest relative gap of a step's total loss (the mean over its
minibatches); `grad_gap` the worst leaf's gap between the norms of Adam's
first moment after the first training step (the gradients as the
optimizer got them); `change_gap` the worst leaf's gap between the norms
of the parameters' change over the steps. A leaf's gap is measured
against the reference's norm of that leaf or of the median leaf,
whichever is larger; leaves whose reference moment is under a thousandth
of the median leaf's move by round-off alone and are left out of
`change_gap`. Over ranks, `replica_gap` holds every rank's learner
against rank 0's, exactly.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Callable, Dict, List

import torch

from benchmark import check, harness, tracing
from benchmark.check import NOT_FINITE, finite, sub_seed
from benchmark.spec import Cell

RATE = "train_env_steps_per_s"
NUMBERS = ("loss_gap", "grad_gap", "change_gap")
# the reference in the nearest precision below the configuration's float32
# (TF32 off): matrix products in TF32, the networks being the only ones
CONTROL = "tf32"
FAULTS = ("unchanged", "half_batch", "altered")


def total_loss(metrics: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
  """The PPO loss of a training step's metrics (means over its minibatch
  steps), as the learner weights its parts."""
  return (metrics["policy_loss"] + cfg.value_loss_coef
          * metrics["value_loss"] - cfg.entropy_cost * metrics["entropy"])


def ppo_config(cell: Cell, ppo_mod, seed: int):
  """The trainer's config; `num_envs` is the global batch, and the seed
  from which each rank's generators are drawn (`mesh.place`) is the run's."""
  t = cell.traffic
  return ppo_mod.Config(**dict(t["ppo"], num_envs=int(t["num_envs"]),
                               seed=sub_seed(seed, "ranks")))


def first_steps(trainer, ts, steps: int, mesh, loss: Callable) -> tuple:
  """`steps` training steps from `ts`: (state, the record the check
  compares)."""
  flat = lambda ts: trainer._flatten(ts.policy_params, ts.value_params)
  record: Dict[str, Any] = {"params0": flat(ts).clone(), "losses": []}
  for k in range(steps):
    ts, m = trainer.training_step(ts, mesh)
    record["losses"].append(loss(m, trainer.cfg))
    if k == 0:
      record["mu1"] = ts.opt_state.mu[0].clone()
  record["paramsK"] = flat(ts).clone()
  record["layout"] = [(k, v.numel()) for k, v in
                      [*ts.policy_params.items(), *ts.value_params.items()]]
  return ts, record


def ppo_setup(cell: Cell, seed: int, device: torch.device, mesh=None,
              mark: Callable[[str], None] = lambda part: None):
  """The program's trainer built from the seed (on a `mesh`, placed on
  this rank's rows) and driven through its first `check_steps` training
  steps: (trainer, state, the record the check compares)."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.train import ppo
  env = myosuite_tpu_torch.make(cell.config["env_id"], device)
  trainer = ppo.PPO(env, ppo_config(cell, ppo, seed))
  gen = torch.Generator(device=device)
  gen.manual_seed(sub_seed(seed, "init"))
  ts = trainer.init(gen)
  if mesh is not None:
    from myosuite_tpu_torch.parallel import mesh as mesh_mod
    ts = mesh_mod.place(ts, trainer, mesh)
  mark("program import, make, reset and init")
  ts, record = first_steps(trainer, ts, int(cell.traffic["check_steps"]),
                           mesh, total_loss)
  mark("first training steps")
  return trainer, ts, record


def host_record(record: Dict[str, Any]) -> Dict[str, Any]:
  return {k: ([float(x) for x in v] if k == "losses" else
              v.cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in record.items()}


def replica_gap(flat: torch.Tensor, mesh) -> float:
  """The largest gap between this rank's learner and rank 0's, over the
  ranks (0 where the learners are replicated bit for bit)."""
  import torch.distributed as dist
  ref = flat.clone()
  dist.broadcast(ref, 0)
  gap = (flat - ref).abs().max().reshape(1)
  gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, 1e30))
  dist.all_reduce(gap, op=dist.ReduceOp.MAX)
  return float(gap)


def drive(cell: Cell, seed: int, seconds: float, trace: bool,
          device: torch.device, t0: float, ctx) -> harness.Window:
  mesh = ctx.mesh
  trainer, ts, record = ppo_setup(cell, seed, device, mesh, ctx.mark)
  env = trainer.env
  ctx.env, ctx.trainer = env, trainer
  win = harness.Window()
  if trace and ctx.rank0:
    harness.install_readers(ctx)
    unroll, update = trainer._unroll, trainer._update_epoch

    def timed_unroll(*a, **kw):
      with ctx.spans.timed("rollout"):
        return unroll(*a, **kw)

    def timed_update(*a, **kw):
      with ctx.spans.timed("update"):
        return update(*a, **kw)
    trainer._unroll, trainer._update_epoch = timed_unroll, timed_update
  bad = torch.zeros((), dtype=torch.int64, device=device)
  tracing.sync(device)
  start = time.perf_counter()
  win.setup_s = start - t0
  deadline = start + seconds
  steps = 0
  while True:
    ts, m = trainer.training_step(ts, mesh)
    bad += (~torch.isfinite(total_loss(m, trainer.cfg))).long()
    steps += 1
    over = time.perf_counter() >= deadline
    if mesh is not None:
      # rank 0's clock ends the window on every rank
      flag = torch.tensor([float(over)], device=device)
      torch.distributed.broadcast(flag, 0)
      over = bool(flag.item())
    if over:
      break
  tracing.sync(device)
  win.window_s = time.perf_counter() - start
  cfg = trainer.cfg
  win.env_steps = steps * cfg.num_envs * cfg.unroll_length
  win.attempted, win.failed = steps, int(bad)
  if mesh is not None:
    flat = trainer._flatten(ts.policy_params, ts.value_params)
    record["replica_gap"] = max(replica_gap(record["paramsK"], mesh),
                                replica_gap(flat, mesh))
  win.record = host_record(record)
  if trace:
    if ctx.rank0:
      trainer._unroll, trainer._update_epoch = unroll, update
    harness.span_stages(ctx, env)
    for name in ("_unroll", "_update_epoch", "_minibatch_step"):
      ctx.undo.append(tracing.wrap_span(trainer, name, "ppo" + name))
    ctx.profile = tracing.Profile(device)

    def sub_window():
      nonlocal ts
      with tracing.label("training_step"):
        ts, _ = trainer.training_step(ts, mesh)
    ctx.profile.run(sub_window)
    ctx.profiled_substeps = cfg.unroll_length * env._n_substeps
  return win


# -- the check ----------------------------------------------------------------

def sample(cell: Cell, seed: int) -> Dict[str, Any]:
  """What the check compares where a run is read outside the window: the
  first training steps, which set-up takes anyway."""
  return {}


def reference_record(cell: Cell, seed: int, device: torch.device, record,
                     mode: str = "fp32", ranks=None) -> Dict[str, Any]:
  """The reference trainer's record of the first `check_steps` training
  steps, in the program's record layout. `ranks` (rank, world size): this
  process is that rank of the default process group, and the reference
  learner is data-parallel over the group as the program's is."""
  from benchmark.reference import parallel
  from benchmark.reference.envs import make
  from benchmark.reference.train import ppo
  t = cell.traffic
  with check.precision(mode):
    env = make(cell.config, device, cell.root)
    trainer = ppo.PPO(env, ppo_config(cell, ppo, seed))
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "init"))
    ts = trainer.init(gen)
    mesh = None
    if ranks is not None:
      mesh = parallel.Mesh(world_size=ranks[1], rank=ranks[0], device=device,
                           group=torch.distributed.group.WORLD)
      ts = parallel.place(ts, trainer, mesh)
    _, rec = first_steps(trainer, ts, int(t["check_steps"]), mesh,
                         lambda m, cfg: float(total_loss(m, cfg)))
  return host_record(rec)


def control_record(cell: Cell, seed: int, device: torch.device, record,
                   ranks=None) -> Dict[str, Any]:
  """The control in the program's place: the reference in CONTROL."""
  return reference_record(cell, seed, device, record, CONTROL, ranks)


def _leaf_norms(flat: torch.Tensor, layout) -> List[float]:
  sizes = [n for _, n in layout]
  return [float(torch.linalg.vector_norm(x.double()))
          for x in torch.split(flat, sizes)]


def _leaf_gap(p: List[float], r: List[float], keep: List[int]) -> float:
  if not keep:
    return 0.0
  med = statistics.median(r[i] for i in keep)
  gaps = [abs(p[i] - r[i]) / max(r[i], med, 1e-30) for i in keep]
  return finite(max(gaps))


def gaps(p: Dict[str, Any], r: Dict[str, Any]) -> Dict[str, float]:
  """The numbers compared, of the program's record against the
  reference's."""
  if p["layout"] != r["layout"] or len(p["losses"]) != len(r["losses"]):
    return {k: NOT_FINITE for k in NUMBERS}
  loss = max(abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(p["losses"], r["losses"]))
  layout = r["layout"]
  mu_p, mu_r = _leaf_norms(p["mu1"], layout), _leaf_norms(r["mu1"], layout)
  every = list(range(len(layout)))
  med = statistics.median(mu_r)
  moving = [i for i in every if mu_r[i] >= 1e-3 * med]
  d_p = _leaf_norms(p["paramsK"] - p["params0"], layout)
  d_r = _leaf_norms(r["paramsK"] - r["params0"], layout)
  out = {"loss_gap": finite(loss), "grad_gap": _leaf_gap(mu_p, mu_r, every),
         "change_gap": _leaf_gap(d_p, d_r, moving)}
  if "replica_gap" in p:
    # the program's learners on every rank against rank 0's, exactly
    out["replica_gap"] = finite(p["replica_gap"])
  return out


# -- faults planted in the program ----------------------------------------------

@contextlib.contextmanager
def fault(mode: str):
  """The program with fault `mode` planted: "unchanged", a training step
  that returns its state unchanged; "half_batch", each minibatch step on
  the first half of its rows, the mean over them; "altered", the first
  entry of every env's observation +1e-3 where the step produces it;
  "exchange", over several ranks, each rank's gather keeping its own rows
  and zeros for the others'."""
  from myosuite_tpu_torch.envs import base
  from myosuite_tpu_torch.train import ppo
  if mode == "unchanged":
    train = ppo.PPO.training_step
    owner, attr = ppo.PPO, "training_step"
    new = lambda self, ts, mesh=None: (ts, train(self, ts, mesh)[1])
  elif mode == "half_batch":
    mb = ppo.PPO._minibatch_step
    owner, attr = ppo.PPO, "_minibatch_step"
    new = lambda self, ts, batch, stats: mb(
        self, ts, [x[:x.shape[0] // 2] for x in batch], stats)
  elif mode == "altered":
    step = base.MyoEnv.step
    owner, attr = base.MyoEnv, "step"

    def new(self, state, action):
      out = step(self, state, action)
      obs = out.obs["state"].clone()
      obs[:, 0] += 1e-3
      return out.replace(obs={**out.obs, "state": obs})
  elif mode == "exchange":
    from myosuite_tpu_torch.parallel import mesh as mesh_mod
    owner, attr = mesh_mod, "gather_env_rows"

    def new(local, mesh):
      if mesh.group is None:
        return local
      b = local.shape[0]
      buf = torch.zeros((mesh.world_size * b,) + tuple(local.shape[1:]),
                        dtype=local.dtype, device=local.device)
      buf[mesh.rank * b:(mesh.rank + 1) * b] = local
      return buf
  else:
    raise ValueError(f"no fault {mode!r} of PPO")
  with harness.patched(owner, attr, new):
    yield


def program_record(cell: Cell, seed: int, device: torch.device,
                   mesh=None) -> Dict[str, Any]:
  """What a run's timed path hands the check: the first training steps."""
  _, _, record = ppo_setup(cell, seed, device, mesh)
  if mesh is not None:
    record["replica_gap"] = replica_gap(record["paramsK"], mesh)
  return host_record(record)

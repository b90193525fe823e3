"""Scale-out over ranks: the env axis split over processes, the learner
replicated.

The JAX package shards the env batch over a device mesh and lets XLA place
the all-reduces. Here every rank is a process with `torch.distributed`
(NCCL between cards, gloo on the CPU or for several ranks on one card):

- each rank steps its own rows of the global env batch, drawing its action
  noise and its auto-reset draws from generators of its own, seeded from
  (seed, rank) by `place`;
- once per training step the trajectory and the last observation are
  gathered onto every rank by one all-reduce of a zero-padded buffer
  (`gather_env_rows`; x + 0 is exact);
- every rank then runs the single-rank statistics update, GAE and PPO
  update on the gathered batch with the replicated permutation generator,
  so the learner is bit-identical on every rank with no gradient
  all-reduce (`ppo.PPO.training_step(ts, mesh)`).

Launch one process per card with torchrun:

  torchrun --nproc_per_node=N -m myosuite_tpu_torch.train.train_ppo --mesh

or call `initialize_distributed` with an `init_method`, world size and rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from myosuite_tpu_torch.physics import types

# environment variables that name a process group (torchrun sets them)
GROUP_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: datetime.timedelta =
                           datetime.timedelta(minutes=10),
                           device=None) -> None:
  """Join the default process group, once per process.

  A no-op when nothing names a group (no argument, none of GROUP_VARS in
  the environment) and when the group exists already. The backend is
  `nccl` for a CUDA `device` (the default) and `gloo` for the CPU unless
  `backend` names one; a failure to join is raised, never replaced by
  another backend. World size and rank not given are read from WORLD_SIZE
  and RANK (`init_method` "env://", torch's default, reads them itself)."""
  named = (backend, init_method, world_size, rank)
  if all(v is None for v in named) and not any(
      v in os.environ for v in GROUP_VARS):
    return
  if dist.is_initialized():
    return
  if backend is None:
    backend = "nccl" if types.resolve_device(device).type == "cuda" \
        else "gloo"
  if world_size is None and "WORLD_SIZE" in os.environ:
    world_size = int(os.environ["WORLD_SIZE"])
  if rank is None and "RANK" in os.environ:
    rank = int(os.environ["RANK"])
  kwargs = dict(backend=backend, timeout=timeout)
  if init_method is not None:
    kwargs["init_method"] = init_method
  if world_size is not None:
    kwargs["world_size"] = world_size
  if rank is not None:
    kwargs["rank"] = rank
  try:
    dist.init_process_group(**kwargs)
  except (RuntimeError, ValueError) as e:
    # only the benign case: another caller joined between the check above
    # and here; anything else (rendezvous unreachable, timeout, a rank
    # mismatch) must surface, or the process trains alone
    msg = str(e).lower()
    if "already initialized" in msg or "twice" in msg:
      return
    raise


@dataclasses.dataclass(frozen=True)
class Mesh:
  """The ranks of one training run: this process's rank, its device, and
  the process group (None when no group exists: one rank)."""
  world_size: int
  rank: int
  device: torch.device
  group: Any = None


def make_mesh(device=None) -> Mesh:
  """The default group as a Mesh. A CUDA device without an index (the
  default) is this rank's card, cuda:$LOCAL_RANK, made current; without a
  group the mesh has one rank."""
  dev = types.resolve_device(device)
  if dev.type == "cuda":
    if dev.index is None:
      dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
  if not dist.is_initialized():
    return Mesh(world_size=1, rank=0, device=dev)
  return Mesh(world_size=dist.get_world_size(), rank=dist.get_rank(),
              device=dev, group=dist.group.WORLD)


def local_env_slice(mesh: Mesh, global_batch: int) -> slice:
  """Rows of the global env batch stepped by this rank: contiguous
  blocks of global_batch / world_size rows in rank order."""
  if global_batch % mesh.world_size:
    raise ValueError(f"the global env batch {global_batch} does not divide "
                     f"by the world size {mesh.world_size}")
  per = global_batch // mesh.world_size
  return slice(mesh.rank * per, (mesh.rank + 1) * per)


def gather_env_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """Every rank's rows (this rank's `local`, (b, ...)) assembled into the
  global (world_size * b, ...) tensor on every rank: one all-reduce (sum)
  of a zero-padded buffer, which NCCL and gloo (also on CUDA tensors)
  both offer. Exact: each entry is one rank's value plus zeros (a -0.0
  comes back +0.0 from two ranks or more). Without a group, `local`."""
  if mesh.group is None:
    return local
  b = local.shape[0]
  buf = torch.zeros((mesh.world_size * b,) + tuple(local.shape[1:]),
                    dtype=local.dtype, device=local.device)
  buf[mesh.rank * b:(mesh.rank + 1) * b] = local
  dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
  return buf


def take_rows(x: Any, rows, batch: int) -> Any:
  """`x` with the rows `rows` (a slice or an index tensor) of every tensor
  whose leading axis is the env axis (length `batch`), descending through
  dicts and dataclasses (a dataclass's STATIC fields, tables without an
  env axis, are kept), as the auto-reset's `_pick_info` descends.
  Anything else is kept."""
  if isinstance(x, torch.Tensor):
    return x[rows] if x.dim() >= 1 and x.shape[0] == batch else x
  if isinstance(x, dict):
    return {k: take_rows(v, rows, batch) for k, v in x.items()}
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    static = getattr(x, "STATIC", ())
    return dataclasses.replace(x, **{
        f.name: take_rows(getattr(x, f.name), rows, batch)
        for f in dataclasses.fields(x) if f.name not in static})
  return x


def rank_seed(seed: int, rank: int, stream: int) -> int:
  """A 63-bit seed of (seed, rank, stream), different for every rank."""
  return int(np.random.SeedSequence((seed, rank, stream)).generate_state(
      1, np.uint64)[0] >> np.uint64(1))


def _reseed(info: dict, mesh: Mesh, seed: int) -> dict:
  """`info` with each generator entry (the env's and the auto-reset's)
  replaced by one of this rank's own, seeded from (seed, rank, entry)."""
  out, stream = {}, 1
  for k, v in info.items():
    if isinstance(v, torch.Generator):
      v = torch.Generator(device=v.device).manual_seed(
          rank_seed(seed, mesh.rank, stream))
      stream += 1
    out[k] = v
  return out


def place(ts, ppo, mesh: Mesh):
  """This rank's TrainState from a single-rank one of the global batch
  (built the same way on every rank from one seed): the rank's rows of
  every env-axis tensor of the env state, its own rollout generator and
  env generators seeded from (config seed, rank); params, optimizer
  state, statistics and the permutation generator stay replicated."""
  batch = ppo.cfg.num_envs
  rows = local_env_slice(mesh, batch)
  env_state = take_rows(ts.env_state, rows, batch)
  env_state = env_state.replace(info=_reseed(env_state.info, mesh,
                                             ppo.cfg.seed))
  rollout = torch.Generator(device=ts.generator.device).manual_seed(
      rank_seed(ppo.cfg.seed, mesh.rank, 0))
  return ts.replace(env_state=env_state, rollout_generator=rollout)


def make_distributed_training_fn(ppo, ts, mesh: Mesh,
                                 steps_per_call: int) -> Callable:
  """A function advancing a placed TrainState by `steps_per_call`
  distributed training steps; it returns the last step's metrics (global:
  the same on every rank). `ts` must come from `place`."""
  if ts.rollout_generator is None:
    raise ValueError("place(ts, ppo, mesh) the TrainState first: it has no "
                     "rollout generator of its rank")

  def run(state):
    for _ in range(steps_per_call):
      state, metrics = ppo.training_step(state, mesh)
    return state, metrics
  return run

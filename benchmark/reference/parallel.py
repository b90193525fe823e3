"""Scale-out of the reference learner: a frozen copy of the program's
`parallel/mesh.py` pieces that data-parallel PPO uses.

Each rank steps its own contiguous block of the global env batch, with
generators of its own seeded from (seed, rank, stream); the trajectory is
gathered onto every rank by one all-reduce of a zero-padded buffer (x + 0
is exact), and every rank runs the same learner on the gathered batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
  world_size: int
  rank: int
  device: torch.device
  group: Any = None


def local_env_slice(mesh: Mesh, global_batch: int) -> slice:
  if global_batch % mesh.world_size:
    raise ValueError(f"the global env batch {global_batch} does not divide "
                     f"by the world size {mesh.world_size}")
  per = global_batch // mesh.world_size
  return slice(mesh.rank * per, (mesh.rank + 1) * per)


def gather_env_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  if mesh.group is None:
    return local
  b = local.shape[0]
  buf = torch.zeros((mesh.world_size * b,) + tuple(local.shape[1:]),
                    dtype=local.dtype, device=local.device)
  buf[mesh.rank * b:(mesh.rank + 1) * b] = local
  dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
  return buf


def take_rows(x: Any, rows, batch: int) -> Any:
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
  return int(np.random.SeedSequence((seed, rank, stream)).generate_state(
      1, np.uint64)[0] >> np.uint64(1))


def _reseed(info: dict, mesh: Mesh, seed: int) -> dict:
  out, stream = {}, 1
  for k, v in info.items():
    if isinstance(v, torch.Generator):
      v = torch.Generator(device=v.device).manual_seed(
          rank_seed(seed, mesh.rank, stream))
      stream += 1
    out[k] = v
  return out


def place(ts, ppo, mesh: Mesh):
  """This rank's TrainState from a single-rank one of the global batch."""
  batch = ppo.cfg.num_envs
  rows = local_env_slice(mesh, batch)
  env_state = take_rows(ts.env_state, rows, batch)
  env_state = env_state.replace(info=_reseed(env_state.info, mesh,
                                             ppo.cfg.seed))
  rollout = torch.Generator(device=ts.generator.device).manual_seed(
      rank_seed(ppo.cfg.seed, mesh.rank, 0))
  return ts.replace(env_state=env_state, rollout_generator=rollout)

"""Running observation statistics for normalization (Welford).

The statistics of the JAX package's `running_stats`: count starts at 1e-4,
a batch is merged with Chan's parallel update, and `normalize` clips to +-5
with an identity std while count <= 1 (so the first rollout's obs are not
blown up by a near-zero m2). With a process `group`, `update` merges every
rank's batch, as the JAX package's `axis_name` path does with psum.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class RunningStats:
  count: torch.Tensor   # () float32
  mean: torch.Tensor    # (dim,)
  m2: torch.Tensor      # (dim,)

  @property
  def std(self) -> torch.Tensor:
    var = self.m2 / torch.clamp(self.count, min=2.0)
    return torch.where(self.count > 1.0,
                       torch.sqrt(torch.clamp(var, min=1e-6)),
                       torch.ones_like(self.m2))


def init(dim: int, device=None) -> RunningStats:
  return RunningStats(
      count=torch.tensor(1e-4, dtype=torch.float32, device=device),
      mean=torch.zeros(dim, dtype=torch.float32, device=device),
      m2=torch.zeros(dim, dtype=torch.float32, device=device))


def update(stats: RunningStats, batch: torch.Tensor,
           group=None) -> RunningStats:
  """Merge a (..., dim) batch; with a process `group`, the batches of all
  its ranks: the global count and mean by one all-reduce, then the
  spread around the global mean by a second."""
  flat = batch.reshape(-1, batch.shape[-1])
  n = float(flat.shape[0])
  bmean = flat.mean(0)
  bm2 = ((flat - bmean) ** 2).sum(0)
  if group is not None:
    tot = torch.cat([bmean * n, bmean.new_tensor([n])])
    dist.all_reduce(tot, group=group)
    nd = tot[-1]
    gmean = tot[:-1] / nd
    bm2 = bm2 + n * (bmean - gmean) ** 2
    dist.all_reduce(bm2, group=group)
    bmean, n = gmean, nd
  delta = bmean - stats.mean
  count = stats.count + n
  mean = stats.mean + delta * n / count
  m2 = stats.m2 + bm2 + delta ** 2 * stats.count * n / count
  return RunningStats(count=count, mean=mean, m2=m2)


def normalize(stats: RunningStats, x: torch.Tensor) -> torch.Tensor:
  return torch.clamp((x - stats.mean) / stats.std, -5.0, 5.0)

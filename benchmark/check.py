"""The output check: what the timed path produced against the plain
reference (`benchmark.reference`), replayed from the same seed.

What a cell compares, and how, is its traffic kind's (`kinds/<kind>.py`:
`reference_record`, `gaps`, and `NUMBERS`, the names compared). This
module holds what every kind shares: the seeds of the streams, the rows a
check samples, the reference's precision, and the dispatch.

A number that is not finite reads as NOT_FINITE, so that it fails every
limit and still prints as a number.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
from typing import Dict

import torch

NOT_FINITE = 1e300


def sub_seed(seed: int, tag: str) -> int:
  """A 63-bit seed for the stream `tag` of run `seed`."""
  h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
  return int.from_bytes(h[:8], "little") >> 1


def sample_rows(seed: int, n: int, k: int) -> torch.Tensor:
  """`k` of the `n` env rows, drawn from the seed, ascending (CPU)."""
  g = torch.Generator().manual_seed(sub_seed(seed, "rows"))
  return torch.randperm(n, generator=g)[:min(k, n)].sort().values


def pick_index(seed: int, n: int) -> int:
  return sub_seed(seed, "pick") % n


def finite(x: float) -> float:
  return x if math.isfinite(x) else NOT_FINITE


# -- precision of the reference ---------------------------------------------

@contextlib.contextmanager
def precision(mode: str):
  """The reference's arithmetic: "fp32" (the configurations' float32, TF32
  off), "tf32" (matrix products in TF32) or "bf16_state" (the physics
  state rounded to bfloat16 after every substep)."""
  import benchmark.reference.physics.forward as fwd
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  step = fwd.step
  try:
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    if mode == "bf16_state":
      def rounded(m, d):
        d = step(m, d)
        return d.replace(**{
            f.name: getattr(d, f.name).to(torch.bfloat16).to(torch.float32)
            for f in dataclasses.fields(d)
            if isinstance(getattr(d, f.name), torch.Tensor)
            and getattr(d, f.name).dtype == torch.float32})
      fwd.step = rounded
    elif mode not in ("fp32", "tf32"):
      raise ValueError(f"no precision {mode!r}")
    yield
  finally:
    fwd.step = step
    torch.backends.cuda.matmul.allow_tf32 = tf32[0]
    torch.backends.cudnn.allow_tf32 = tf32[1]


# -- dispatch -----------------------------------------------------------------

def compare(cell, seed: int, device: torch.device, record, mesh=None
            ) -> Dict[str, float]:
  """The numbers compared of a run; `mesh` the program's mesh of ranks,
  whose rank and size the reference takes (every rank calls this)."""
  ranks = None if mesh is None else (mesh.rank, mesh.world_size)
  kind = cell.kind
  return kind.gaps(record, kind.reference_record(cell, seed, device, record,
                                                 ranks=ranks))

"""Success-threshold curriculum: advance a difficulty level once the
success rate has held a threshold for `patience` updates.

The JAX package's `utils.curriculum`, on tensors of any shape (one level
per element, e.g. per env group), state in and state out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myosuite_tpu_torch.physics import types


class CurriculumState(NamedTuple):
  level: torch.Tensor    # int32 difficulty level
  streak: torch.Tensor   # int32 updates in a row at or above the threshold


def init(level: int = 0, device=None) -> CurriculumState:
  """Level `level` with no streak, on `device` (default cuda)."""
  dev = types.resolve_device(device)
  return CurriculumState(
      level=torch.tensor(level, dtype=torch.int32, device=dev),
      streak=torch.zeros((), dtype=torch.int32, device=dev))


def update(state: CurriculumState, success_rate: torch.Tensor,
           threshold: float = 0.8, patience: int = 3,
           max_level: int = 10) -> CurriculumState:
  """Advance (up to max_level) when success_rate >= threshold for
  `patience` updates in a row; the streak restarts at each advance."""
  hit = success_rate >= threshold
  streak = torch.where(hit, state.streak + 1, torch.zeros_like(state.streak))
  advance = streak >= patience
  level = torch.where(advance, torch.clamp(state.level + 1, max=max_level),
                      state.level)
  streak = torch.where(advance, torch.zeros_like(streak), streak)
  return CurriculumState(level=level, streak=streak)

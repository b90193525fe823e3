"""Trajectory generators: minimum jerk and cyclic references.

The JAX package's `utils.trajectories`, on tensors: each function takes
its endpoints with any leading batch axes, (..., dim), and answers on
their device.
"""

from __future__ import annotations

import math

import torch


def _unit_time(x: torch.Tensor, horizon: int) -> torch.Tensor:
  """(horizon, 1) samples of [0, 1]."""
  return torch.linspace(0.0, 1.0, horizon, dtype=x.dtype,
                        device=x.device)[:, None]


def min_jerk(x0: torch.Tensor, xf: torch.Tensor,
             horizon: int) -> torch.Tensor:
  """(..., horizon, dim) positions from x0 to xf along the quintic
  10t^3 - 15t^4 + 6t^5 (zero boundary velocity and acceleration)."""
  t = _unit_time(x0, horizon)
  s = 10 * t ** 3 - 15 * t ** 4 + 6 * t ** 5
  return x0[..., None, :] + s * (xf - x0)[..., None, :]


def min_jerk_vel(x0: torch.Tensor, xf: torch.Tensor, horizon: int,
                 duration: float) -> torch.Tensor:
  """(..., horizon, dim) velocities of the minimum-jerk profile."""
  t = _unit_time(x0, horizon)
  ds = (30 * t ** 2 - 60 * t ** 3 + 30 * t ** 4) / duration
  return ds * (xf - x0)[..., None, :]


def cyclic(amplitude: torch.Tensor, period: float, phase: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
  """amplitude sin(2 pi t / period + phase), broadcast."""
  return amplitude * torch.sin(2 * math.pi * t / period + phase)

"""Robot layer: the bridge between simulation and hardware, batched.

The JAX package's `robot` module: a uniform view over sensors and
actuators with sensor noise and position / velocity limits on controls,
as functions over the physics `Data` of a batch of envs (the JAX package
vmaps the same functions). Noise comes from an explicit `torch.Generator`
on the data's device. The JAX module's unused calibration record
(`SensorSpec`) and `pos_limit_margin` argument are left out.

Code for particular devices is out of scope; the `HardwareDriver`
protocol documents the surface a device implements to plug into the same
view.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Protocol

import numpy as np
import torch

from myosuite_tpu_torch.physics import forward
from myosuite_tpu_torch.physics.types import Data, Model


class Robot:
  """Sensor and actuator view over a Model, for a batch of envs."""

  def __init__(self, model: Model, sensor_noise: float = 0.0,
               vel_limit: Optional[float] = None):
    self._model = model
    self._noise = sensor_noise
    self._vel_limit = vel_limit
    self._limited = torch.as_tensor(
        np.asarray(model.actuator_ctrllimited, dtype=bool),
        device=model.device)

  # -- sensors ------------------------------------------------------------
  def get_sensors(self, d: Data, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """Joint-space sensors {time, qpos, qvel, act}, each (B, ...); with
    sensor noise and a generator, qpos then qvel get gaussian noise."""
    out = {"time": d.time, "qpos": d.qpos, "qvel": d.qvel, "act": d.act}
    if self._noise > 0 and generator is not None:
      for k in ("qpos", "qvel"):
        out[k] = out[k] + self._noise * torch.randn(
            out[k].shape, generator=generator, device=out[k].device,
            dtype=out[k].dtype)
    return out

  # -- actuation ----------------------------------------------------------
  def normalize_actions(self, ctrl: torch.Tensor) -> torch.Tensor:
    """Policy actions in [-1, 1] mapped into each limited actuator's
    ctrlrange; an unlimited actuator's passes through."""
    lo = self._model.actuator_ctrlrange[:, 0]
    hi = self._model.actuator_ctrlrange[:, 1]
    mapped = lo + 0.5 * (ctrl + 1.0) * (hi - lo)
    return torch.where(self._limited, mapped, ctrl)

  def process_actuator(self, d: Data, ctrl: torch.Tensor,
                       dt: float) -> torch.Tensor:
    """Controls limited in rate (vel_limit * dt around the actuator
    length) and clamped into each limited actuator's ctrlrange."""
    out = ctrl
    if self._vel_limit is not None:
      max_delta = self._vel_limit * dt
      out = torch.clamp(out, d.actuator_length - max_delta,
                        d.actuator_length + max_delta)
    rng = self._model.actuator_ctrlrange
    return torch.where(self._limited,
                       torch.clamp(out, rng[:, 0], rng[:, 1]), out)


class SensorCache:
  """Fixed-depth history of sensor dicts (hardware loops and sensor-delay
  emulation), host side."""

  def __init__(self, depth: int = 5):
    self._buf = collections.deque(maxlen=depth)

  def append(self, sensors: Dict[str, torch.Tensor]) -> None:
    self._buf.append(sensors)

  def latest(self) -> Optional[Dict[str, torch.Tensor]]:
    return self._buf[-1] if self._buf else None

  def delayed(self, steps: int) -> Optional[Dict[str, torch.Tensor]]:
    """The reading `steps` control periods ago (clamped to the history)."""
    if not self._buf:
      return None
    return self._buf[max(-len(self._buf), -(steps + 1))]

  def __len__(self):
    return len(self._buf)


def sensor2sim(model: Model, data: Data,
               sensors: Dict[str, torch.Tensor]) -> Data:
  """An observed Data: `data` with the (noisy or delayed) sensor state
  written in and its kinematic quantities derived again from it, so task
  code reads the observed state, not the true one."""
  d = data.replace(qpos=sensors["qpos"], qvel=sensors["qvel"])
  if "act" in sensors and model.na:
    d = d.replace(act=sensors["act"])
  return forward.fwd_velocity(model, forward.fwd_position(model, d))


class HardwareDriver(Protocol):
  """What a physical device implements to sit behind the Robot view."""

  def connect(self) -> None: ...
  def get_sensors(self) -> Dict[str, np.ndarray]: ...
  def apply_controls(self, ctrl: np.ndarray) -> None: ...
  def close(self) -> None: ...

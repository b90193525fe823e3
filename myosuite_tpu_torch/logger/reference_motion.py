"""Reference motion container for the tracking tasks.

A reference is FIXED (one frame), RANDOM (a range of poses between two
rows) or TRACK (a time-indexed trajectory), inferred from the leading
dimension of its robot array (1 / 2 / more), as in the JAX package's
`logger.reference_motion`. TRACK lookups interpolate linearly between the
two frames around a time; every query takes a (B,) tensor of times, one
per env, and answers with (B, n) tensors, with no host round trip.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import numpy as np
import torch

from myosuite_tpu_torch.physics import types


class RefType(enum.IntEnum):
  FIXED = 0
  RANDOM = 1
  TRACK = 2


@dataclasses.dataclass(frozen=True)
class ReferenceMotion:
  """Reference-motion data (float32 tensors on one device) and queries."""
  time: torch.Tensor         # (T,)
  robot: torch.Tensor        # (T, nq_robot) joint-space reference
  object: torch.Tensor       # (T, 7) object pose (pos + quat)
  robot_vel: torch.Tensor    # (T, nq_robot)
  robot_init: torch.Tensor   # (nq_robot,) initial pose
  object_init: torch.Tensor  # (7,)
  ref_type: int
  horizon: float

  @classmethod
  def from_arrays(cls, time, robot, obj=None, robot_vel=None,
                  robot_init=None, object_init=None,
                  device=None) -> "ReferenceMotion":
    """A reference from arrays on `device` (default "cuda"; raises without
    CUDA unless another device is named). Without `robot_vel`, velocities
    are the forward differences of `robot` (the last repeated); without
    inits, the first frames."""
    dev = types.resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32),
                                    device=dev)
    time = torch.atleast_1d(f32(time))
    robot = torch.atleast_2d(f32(robot))
    n = robot.shape[0]
    rtype = (RefType.FIXED if n == 1 else RefType.RANDOM if n == 2
             else RefType.TRACK)
    if obj is None:
      obj = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32,
                         device=dev).repeat(n, 1)
    else:
      obj = torch.atleast_2d(f32(obj))
    if robot_vel is None:
      if n > 1:
        dt = torch.diff(time)[:, None]
        vel = torch.diff(robot, dim=0) / torch.clamp(dt, min=1e-8)
        robot_vel = torch.cat([vel, vel[-1:]], 0)
      else:
        robot_vel = torch.zeros_like(robot)
    else:
      robot_vel = torch.atleast_2d(f32(robot_vel))
    robot_init = robot[0] if robot_init is None else f32(robot_init)
    object_init = obj[0] if object_init is None else f32(object_init)
    return cls(time=time, robot=robot, object=obj, robot_vel=robot_vel,
               robot_init=robot_init, object_init=object_init,
               ref_type=int(rtype), horizon=float(time[-1]))

  @classmethod
  def from_npz(cls, path: str, device=None) -> "ReferenceMotion":
    """Load a mocap npz in the reference schema (time, robot, robot_vel,
    object, robot_init, object_init; all but time and robot optional)."""
    with np.load(path, allow_pickle=True) as data:
      get = lambda k: data[k] if k in data.files else None
      return cls.from_arrays(data["time"], data["robot"], get("object"),
                             get("robot_vel"), get("robot_init"),
                             get("object_init"), device=device)

  # -- queries ----------------------------------------------------------
  def find_timeslot(self, t: torch.Tensor):
    """(index below, index above, blend) for the times t, clamped to the
    reference's range."""
    time = self.time
    t = torch.clamp(t, time[0], time[-1])
    hi = torch.clamp(torch.searchsorted(time, t, right=True), 1,
                     time.shape[0] - 1)
    lo = hi - 1
    span = torch.clamp(time[hi] - time[lo], min=1e-8)
    return lo, hi, (t - time[lo]) / span

  def get_reference(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{robot, robot_vel, object} at the times t (B,): interpolated for a
    TRACK reference, the first frame for the others."""
    keys = {"robot": self.robot, "robot_vel": self.robot_vel,
            "object": self.object}
    if self.ref_type != RefType.TRACK:
      return {k: v[0].expand(t.shape + v.shape[1:]) for k, v in keys.items()}
    lo, hi, b = self.find_timeslot(t)
    b = b[..., None]
    return {k: (1.0 - b) * v[lo] + b * v[hi] for k, v in keys.items()}

  def get_init(self) -> Dict[str, torch.Tensor]:
    return {"robot": self.robot_init, "robot_vel": self.robot_vel[0],
            "object": self.object_init}

  def sample(self, generator: torch.Generator, batch: int) -> torch.Tensor:
    """RANDOM references: (batch, nq_robot) poses uniform between the two
    rows."""
    lo, hi = self.robot[0], self.robot[-1]
    u = torch.rand((batch,) + lo.shape, generator=generator,
                   device=lo.device)
    return u * (hi - lo) + lo

"""Quaternion math under the names of the reference's `quat_math`, as the
JAX package's `utils.quat_math` gives them: quaternions [w, x, y, z]. The
functions take tensors with any leading batch axes (the engine's
`physics.math`), where the JAX package's act on one quaternion or matrix.
"""

from __future__ import annotations

import torch

from myosuite_tpu_torch.physics import math as _m

mulQuat = _m.mul_quat
negQuat = _m.neg_quat
quat2Vel = _m.quat_to_vel
diffQuat = _m.quat_diff
quatDiff2Vel = _m.quat_diff_vel
axis_angle2quat = _m.axis_angle_to_quat
euler2quat = _m.euler_to_quat
quat2mat = _m.quat_to_mat
mat2quat = _m.mat_to_quat
rotVecQuat = _m.rotate
quatIntegrate = _m.quat_integrate


def quat2euler(quat: torch.Tensor) -> torch.Tensor:
  """Quaternions (..., 4) -> intrinsic XYZ euler angles (..., 3)."""
  return mat2euler(_m.quat_to_mat(quat))


def mat2euler(mat: torch.Tensor) -> torch.Tensor:
  """Rotation matrices (..., 3, 3) -> intrinsic XYZ euler angles."""
  sy = torch.sqrt(mat[..., 0, 0] ** 2 + mat[..., 1, 0] ** 2)
  singular = sy < 1e-6
  x = torch.where(singular, torch.atan2(-mat[..., 1, 2], mat[..., 1, 1]),
                  torch.atan2(mat[..., 2, 1], mat[..., 2, 2]))
  y = torch.atan2(-mat[..., 2, 0], sy)
  z = torch.where(singular, torch.zeros_like(sy),
                  torch.atan2(mat[..., 1, 0], mat[..., 0, 0]))
  return torch.stack([x, y, z], -1)


def euler2mat(euler: torch.Tensor) -> torch.Tensor:
  """Intrinsic XYZ euler angles (..., 3) -> rotation matrices."""
  return _m.quat_to_mat(_m.euler_to_quat(euler))

"""Quaternion and spatial-algebra helpers, batched over leading axes.

Conventions follow MuJoCo: quaternions are [w, x, y, z], spatial 6-vectors
are [angular(3); linear(3)]. Every function acts on the last axis (or last
two for matrices) and broadcasts over any leading axes, so one call covers
a whole (env, body) batch.

Matrix products here and in the engine run in full float32: the port never
enables TF32 (the JAX package's `math.mm` uses HIGHEST precision for the
same reason: mass matrices span ~1e6 in conditioning).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_EPS = 1e-12


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, with broadcasting."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return (a * b).sum(-1)


# Batch-invariant products. cuBLAS picks a GEMM / GEMV algorithm from the
# problem's size, and a product that folds the env axis into M or N (or the
# batch count of a bmm) sums in another order at another batch size, so a
# batch-1 step was not bit-equal to its row of a batch. The helpers below
# sum over the contracted axis with elementwise adds in an order set by
# that axis's length alone, never by the batch or by a reduction kernel's
# launch configuration.


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  """Sum over `dim` with elementwise adds: up to 4 terms left to right;
  more zero-padded to a power of two and halved pairwise (element i plus
  element i + h, h = half the padded length), one add per halving."""
  dim = dim % x.dim()
  n = x.shape[dim]
  if n == 0:
    return x.new_zeros(x.shape[:dim] + x.shape[dim + 1:])
  if n <= 4:
    terms = x.unbind(dim)
    out = terms[0]
    for t in terms[1:]:
      out = out + t
    return out
  p = 1 << (n - 1).bit_length()
  if p != n:
    x = torch.cat([x, x.new_zeros(x.shape[:dim] + (p - n,)
                                  + x.shape[dim + 1:])], dim)
  while p > 1:
    p //= 2
    x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
  return x.squeeze(dim)


def fixed_mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat (..., m, k) @ v (..., k) -> (..., m), leading axes broadcast."""
  return fixed_sum(mat * v[..., None, :], -1)


def fixed_vm(v: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
  """v (..., k) @ mat (..., k, n) -> (..., n), leading axes broadcast."""
  return fixed_sum(v[..., :, None] * mat, -2)


def fixed_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a (..., m, k) @ b (..., k, n) -> (..., m, n), leading axes
  broadcast. Holds a (..., m, k, n) product: for small k."""
  return fixed_sum(a[..., :, :, None] * b[..., None, :, :], -2)


class FixedRows(NamedTuple):
  """A constant (m, k) matrix kept as its nonzeros, row by row: index
  (m, r) into the k columns (k itself for padding, which reads a zero) and
  weight (m, r), None where every nonzero is 1."""
  index: torch.Tensor
  weight: Optional[torch.Tensor]


def fixed_rows(mat, device) -> FixedRows:
  """FixedRows of a host (m, k) matrix; r is the most nonzeros of a row,
  rounded up to a power of two."""
  mat = np.asarray(mat, dtype=np.float32)
  m, k = mat.shape
  nz = [np.nonzero(row)[0] for row in mat]
  r = 1 << (max([len(c) for c in nz] + [1]) - 1).bit_length()
  index = np.full((m, r), k, dtype=np.int64)
  weight = np.zeros((m, r), dtype=np.float32)
  for i, c in enumerate(nz):
    index[i, :len(c)] = c
    weight[i, :len(c)] = mat[i, c]
  ones = bool(np.all(mat[mat != 0.0] == 1.0))
  return FixedRows(torch.as_tensor(index, device=device),
                   None if ones else torch.as_tensor(weight, device=device))


def rows_apply(rows: FixedRows, x: torch.Tensor, dim: int) -> torch.Tensor:
  """The matrix of `rows` (m, k) applied along axis `dim` of x (size k):
  out[..., i, ...] = sum_j mat[i, j] x[..., j, ...], axis `dim` becoming
  size m; the nonzeros of row i summed by `fixed_sum`."""
  dim = dim % x.dim()
  m, r = rows.index.shape
  xz = torch.cat([x, x.new_zeros(x.shape[:dim] + (1,) + x.shape[dim + 1:])],
                 dim)
  g = xz.index_select(dim, rows.index.reshape(-1))
  g = g.reshape(x.shape[:dim] + (m, r) + x.shape[dim + 1:])
  if rows.weight is not None:
    g = g * rows.weight.reshape((m, r) + (1,) * (x.dim() - dim - 1)).to(
        x.dtype)
  return fixed_sum(g, dim + 1)


def normalize(v: torch.Tensor) -> torch.Tensor:
  n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
  return v / torch.clamp(n, min=_EPS)


def norm_safe(v: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(torch.clamp((v * v).sum(-1), min=_EPS))


def mul_quat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Hamilton product a*b."""
  aw, ax, ay, az = a.unbind(-1)
  bw, bx, by, bz = b.unbind(-1)
  return torch.stack([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
  ], dim=-1)


def neg_quat(q: torch.Tensor) -> torch.Tensor:
  return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def rotate(vec: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """Rotate 3-vectors by unit quaternions (world = R(q) @ local)."""
  u = q[..., 1:4]
  w = q[..., :1]
  uv = cross(u, vec)
  uuv = cross(u, uv)
  return vec + 2.0 * (w * uv + uuv)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  return torch.stack([
      torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
      torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
      torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
  ], dim=-2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), w >= 0:
  Shepperd's four constructions, each env taking the one its trace and
  diagonal select, as the JAX package's branch-free `mat_to_quat`."""
  m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
  m01, m02, m10 = m[..., 0, 1], m[..., 0, 2], m[..., 1, 0]
  m12, m20, m21 = m[..., 1, 2], m[..., 2, 0], m[..., 2, 1]
  tr = m00 + m11 + m22
  root = lambda x: torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0
  s = root(tr + 1.0)
  case_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                        (m10 - m01) / s], -1)
  s = root(1.0 + m00 - m11 - m22)
  case_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                        (m02 + m20) / s], -1)
  s = root(1.0 - m00 + m11 - m22)
  case_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                        (m12 + m21) / s], -1)
  s = root(1.0 - m00 - m11 + m22)
  case_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                        0.25 * s], -1)
  pick = lambda c, a, b: torch.where(c[..., None], a, b)
  q = pick(tr > 0.0, case_w,
           pick((m00 > m11) & (m00 > m22), case_x,
                pick(m11 > m22, case_y, case_z)))
  q = torch.where(q[..., :1] < 0, -q, q)
  return normalize(q)


def quat_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The rotation taking a to b: a^-1 * b."""
  return mul_quat(neg_quat(a), b)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor
                       ) -> torch.Tensor:
  """(unit axis (..., 3), angle (...)) -> quaternion (..., 4)."""
  half = 0.5 * angle
  return torch.cat([torch.cos(half)[..., None],
                    axis * torch.sin(half)[..., None]], dim=-1)


def quat_to_vel(q: torch.Tensor, dt: float = 1.0) -> torch.Tensor:
  """Quaternion -> angular velocity over dt."""
  sin_half = norm_safe(q[..., 1:4])
  axis = q[..., 1:4] / torch.clamp(sin_half, min=_EPS)[..., None]
  angle = 2.0 * torch.atan2(sin_half, q[..., 0])
  angle = torch.where(angle > torch.pi, angle - 2.0 * torch.pi, angle)
  return axis * (angle / dt)[..., None]


def quat_diff_vel(a: torch.Tensor, b: torch.Tensor,
                  dt: float = 1.0) -> torch.Tensor:
  """Angular velocity that rotates a into b over dt."""
  return quat_to_vel(quat_diff(a, b), dt)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor,
                   dt: float) -> torch.Tensor:
  """q * exp(0.5 * omega * dt) (MuJoCo's mju_quatIntegrate)."""
  n = norm_safe(omega)
  angle = n * dt
  axis = omega / torch.clamp(n, min=_EPS)[..., None]
  return normalize(mul_quat(q, axis_angle_to_quat(axis, angle)))


def motion_cross(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Spatial motion cross product v x u."""
  ang = cross(v[..., :3], u[..., :3])
  lin = cross(v[..., 3:], u[..., :3]) + cross(v[..., :3], u[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial cross product v x* f for force vectors."""
  ang = cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:])
  lin = cross(v[..., :3], f[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def inert_vec(inert10: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """10-parameter spatial inertia [I00 I11 I22 I01 I02 I12, m*c, m] times a
  motion vector; returns the spatial force."""
  i = inert10
  w = v[..., :3]
  imat_w = torch.stack([
      i[..., 0] * w[..., 0] + i[..., 3] * w[..., 1] + i[..., 4] * w[..., 2],
      i[..., 3] * w[..., 0] + i[..., 1] * w[..., 1] + i[..., 5] * w[..., 2],
      i[..., 4] * w[..., 0] + i[..., 5] * w[..., 1] + i[..., 2] * w[..., 2],
  ], dim=-1)
  h = i[..., 6:9]
  mass = i[..., 9:10]
  ang = imat_w + cross(h, v[..., 3:])
  lin = mass * v[..., 3:] - cross(h, w)
  return torch.cat([ang, lin], dim=-1)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
  """XYZ-intrinsic Euler angles (..., 3) -> quaternions (..., 4) (MuJoCo's
  'xyz' eulerseq): q = qx(e0) * qy(e1) * qz(e2)."""
  axes = torch.eye(3, dtype=euler.dtype, device=euler.device)
  qx, qy, qz = (axis_angle_to_quat(axes[i], euler[..., i]) for i in range(3))
  return mul_quat(mul_quat(qx, qy), qz)

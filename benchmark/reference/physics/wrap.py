"""Tendon wrapping over sphere and cylinder geoms (mju_wrap semantics).

Computes the taut-path tangent points and arc length without branches
(`torch.where` masks), batched over any leading axes. Sidesite-inside-geom
routing is not supported; such segments stay straight, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.physics import math

_EPS = 1e-9


def _cross2(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _circle(r: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
  return r[..., None] * torch.stack([torch.cos(th), torch.sin(th)], -1)


def _wrap2d(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
            sd: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """2D circle wrap of segment a-b; returns (t1, t2, arclen), arclen < 0
  when the segment does not wrap."""
  da = math.norm_safe(a)
  db = math.norm_safe(b)
  inside = (da <= r) | (db <= r)

  dif = b - a
  dd = torch.clamp(math.dot(dif, dif), min=_EPS)
  t = torch.clamp(-math.dot(a, dif) / dd, 0.0, 1.0)
  closest = a + t[..., None] * dif
  intersects = math.dot(closest, closest) <= r * r

  phi_a = torch.atan2(a[..., 1], a[..., 0])
  phi_b = torch.atan2(b[..., 1], b[..., 0])
  alpha_a = torch.acos(torch.clamp(r / torch.clamp(da, min=_EPS), -1.0, 1.0))
  alpha_b = torch.acos(torch.clamp(r / torch.clamp(db, min=_EPS), -1.0, 1.0))

  two_pi = 2.0 * torch.pi
  th1_cw = phi_a - alpha_a
  th2_cw = phi_b + alpha_b
  arc_cw = torch.remainder(th1_cw - th2_cw, two_pi)
  th1_ccw = phi_a + alpha_a
  th2_ccw = phi_b - alpha_b
  arc_ccw = torch.remainder(th2_ccw - th1_ccw, two_pi)

  chord = b - a
  if sd is not None:
    # wrap on the sidesite's side of the chord; a sidesite also forces the
    # wrap when the segment passes on the far side of the circle center
    s_side = torch.sign(_cross2(chord, sd - a))
    mid_cw = _circle(r, th1_cw - 0.5 * arc_cw)
    use_cw = torch.sign(_cross2(chord, mid_cw - a)) == s_side
    opposite = math.dot(closest, sd) < 0.0
    valid = ~inside & (intersects | opposite)
  else:
    use_cw = arc_cw <= arc_ccw
    valid = ~inside & intersects & (torch.minimum(arc_cw, arc_ccw)
                                    <= torch.pi)

  th1 = torch.where(use_cw, th1_cw, th1_ccw)
  th2 = torch.where(use_cw, th2_cw, th2_ccw)
  arc = torch.where(use_cw, arc_cw, arc_ccw)
  arclen = torch.where(valid, r * arc, torch.full_like(arc, -1.0))
  return _circle(r, th1), _circle(r, th2), arclen


def _mat_t_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return (mat * v[..., :, None]).sum(-2)


def _mat_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return (mat * v[..., None, :]).sum(-1)


def wrap(x0: torch.Tensor, x1: torch.Tensor, gpos: torch.Tensor,
         gmat: torch.Tensor, radius: torch.Tensor,
         side: Optional[torch.Tensor], is_sphere: bool
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Wrap segments x0-x1 around sphere or cylinder geoms.

  Returns (w1_world, w2_world, wlen); wlen < 0 means no wrap (straight).
  """
  p0 = _mat_t_vec(gmat, x0 - gpos)
  p1 = _mat_t_vec(gmat, x1 - gpos)
  sd = None if side is None else _mat_t_vec(gmat, side - gpos)

  if is_sphere:
    # 2D frame of the plane through p0, p1 and the center
    e1 = p0 / torch.clamp(math.norm_safe(p0), min=_EPS)[..., None]
    n = math.cross(p0, p1)
    ex = p0.new_tensor([1.0, 0.0, 0.0])
    ey = p0.new_tensor([0.0, 1.0, 0.0])
    alt = math.cross(p0, ex)
    alt = torch.where((math.norm_safe(alt) > 1e-7)[..., None], alt,
                      math.cross(p0, ey))
    n = torch.where((math.norm_safe(n) > 1e-7)[..., None], n, alt)
    n = n / torch.clamp(math.norm_safe(n), min=_EPS)[..., None]
    e2 = math.cross(n, e1)
    to2d = torch.stack([e1, e2], dim=-2)                # (..., 2, 3)
    s2 = None if sd is None else _mat_vec(to2d, sd)
    t1, t2, wlen = _wrap2d(_mat_vec(to2d, p0), _mat_vec(to2d, p1), radius,
                           s2)
    w1l = _mat_t_vec(to2d, t1)
    w2l = _mat_t_vec(to2d, t2)
  else:
    # cylinder: 2D wrap in the cross-section; z follows the path length
    a2, b2 = p0[..., :2], p1[..., :2]
    s2 = None if sd is None else sd[..., :2]
    t1, t2, arclen = _wrap2d(a2, b2, radius, s2)
    la = math.norm_safe(a2 - t1)
    lb = math.norm_safe(b2 - t2)
    total = torch.clamp(la + arclen + lb, min=_EPS)
    dz_all = p1[..., 2] - p0[..., 2]
    z1 = p0[..., 2] + dz_all * la / total
    z2 = p0[..., 2] + dz_all * (la + arclen) / total
    w1l = torch.cat([t1, z1[..., None]], -1)
    w2l = torch.cat([t2, z2[..., None]], -1)
    dz = z2 - z1
    wlen = torch.where(
        arclen >= 0,
        torch.sqrt(torch.clamp(arclen * arclen + dz * dz, min=0.0)),
        torch.full_like(arclen, -1.0))

  return _mat_vec(gmat, w1l) + gpos, _mat_vec(gmat, w2l) + gpos, wlen

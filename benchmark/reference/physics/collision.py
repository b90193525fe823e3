"""Narrow-phase collision: batched primitive pair functions.

The host groups every admissible geom pair (io._collision_pairs) by class
(type1, type2, and the mesh for mesh pairs); each step makes one batched
call per class group over (env, pair) and writes the group's results into
fixed contact slots. Activity is dist < includemargin, not a shape.

Every pair function takes geom poses and sizes with any leading axes,
p (..., 3), mat (..., 3, 3), size (..., 3), and returns
(dist (..., k), pos (..., k, 3), normal (..., k, 3)) for its k slots.
Heightfield functions read each env's own `Data.hfield_data`, so their
leading axis is the env axis.

Classes: plane-{sphere, capsule, ellipsoid, box},
sphere-{sphere, capsule, ellipsoid, box}, capsule-{capsule, box}, box-box,
hfield-{sphere, capsule, box} (the local tangent plane of the bilinear
height grid) and {plane, sphere, capsule, box}-mesh (closest point over
every triangle of a convex mesh, tables built once per mesh with the
Model). Clamps and tie-breaks follow the JAX package's collision module.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.physics import math
from benchmark.reference.physics.types import (Data, GeomType, Model,
                                              index_tensor)

_EPS = 1e-9


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return (a * b).sum(-1)


def _mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat @ v over leading axes."""
  return math.fixed_mv(mat, v)


def _mtv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat^T @ v over leading axes."""
  return math.fixed_vm(v, mat)


def _lowest(x: torch.Tensor, k: int) -> torch.Tensor:
  """Indices of the k smallest entries of the last axis, ascending, the
  lower index first among equal entries (the order of lax.top_k(-x, k))."""
  return torch.sort(x, dim=-1, stable=True)[1][..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x (..., n, 3) at idx (..., k) along the n axis."""
  return torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))


def _make_frame(n: torch.Tensor) -> torch.Tensor:
  """Contact frames (..., 3, 3), rows normal, tangent 1, tangent 2."""
  n = n / torch.clamp(math.norm_safe(n), min=_EPS)[..., None]
  ex = n.new_tensor([1.0, 0.0, 0.0])
  ey = n.new_tensor([0.0, 1.0, 0.0])
  a = torch.where((n[..., 0].abs() < 0.5)[..., None], ex, ey)
  t1 = math.cross(n, a)
  t1 = t1 / torch.clamp(math.norm_safe(t1), min=_EPS)[..., None]
  t2 = math.cross(n, t1)
  return torch.stack([n, t1, t2], -2)


def _one(dist, pos, n):
  """A single-slot result: add the slot axis."""
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _stack(outs):
  """Results of several single-slot queries, one slot each."""
  return (torch.stack([o[0] for o in outs], -1),
          torch.stack([o[1] for o in outs], -2),
          torch.stack([o[2] for o in outs], -2))


# ---- primitives -----------------------------------------------------------


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  dist = _dot(n, p2 - p1) - s2[..., 0]
  pos = p2 - n * (s2[..., 0] + 0.5 * dist)[..., None]
  return _one(dist, pos, n)


def _capsule_ends(p, mat, size):
  axis = mat[..., :, 2] * size[..., 1:2]
  return p - axis, p + axis


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  r = s2[..., 0]
  outs = []
  for e in _capsule_ends(p2, m2, s2):
    dist = _dot(n, e - p1) - r
    outs.append((dist, e - n * (r + 0.5 * dist)[..., None], n))
  return _stack(outs)


def _plane_ellipsoid(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  nl = _mtv(m2, n)
  size = s2[..., :3]
  denom = torch.sqrt(torch.clamp(((nl * size) ** 2).sum(-1), min=_EPS))
  sp = p2 + _mv(m2, -(size ** 2 * nl) / denom[..., None])
  dist = _dot(n, sp - p1)
  pos = sp - 0.5 * dist[..., None] * n
  return _one(dist, pos, n)


_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                   for sz in (-1, 1)], dtype=np.float32)


def _box_corners(p, mat, size):
  """(..., 8, 3) world corners."""
  signs = torch.as_tensor(_SIGNS, device=p.device)
  local = signs * size[..., None, :3]
  return p[..., None, :] + math.fixed_mm(local, mat.transpose(-1, -2))


def _plane_box(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  corners = _box_corners(p2, m2, s2)
  dists = _mv(corners, n) - _dot(p1, n)[..., None]
  idx = _lowest(dists, 4)
  dist = torch.gather(dists, -1, idx)
  pos = _take(corners, idx) - 0.5 * dist[..., None] * n[..., None, :]
  return dist, pos, n[..., None, :].expand(pos.shape)


def _sphere_sphere_pts(c1, r1, c2, r2):
  dif = c2 - c1
  dc = math.norm_safe(dif)
  n = dif / torch.clamp(dc, min=_EPS)[..., None]
  dist = dc - (r1 + r2)
  pos = c1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  return _one(*_sphere_sphere_pts(p1, s1[..., 0], p2, s2[..., 0]))


def _closest_on_seg(pt, a, b):
  ab = b - a
  t = torch.clamp(_dot(pt - a, ab) / torch.clamp(_dot(ab, ab), min=_EPS),
                  0.0, 1.0)
  return a + t[..., None] * ab


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  a, b = _capsule_ends(p2, m2, s2)
  c = _closest_on_seg(p1, a, b)
  return _one(*_sphere_sphere_pts(p1, s1[..., 0], c, s2[..., 0]))


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  a1, b1 = _capsule_ends(p1, m1, s1)
  a2, b2 = _capsule_ends(p2, m2, s2)
  d1 = b1 - a1
  d2 = b2 - a2
  r = a1 - a2
  a = _dot(d1, d1)
  e = _dot(d2, d2)
  f = _dot(d2, r)
  c = _dot(d1, r)
  b = _dot(d1, d2)
  denom = torch.clamp(a * e - b * b, min=_EPS)
  s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
  t = torch.clamp((b * s + f) / torch.clamp(e, min=_EPS), 0.0, 1.0)
  s = torch.clamp((b * t - c) / torch.clamp(a, min=_EPS), 0.0, 1.0)
  return _one(*_sphere_sphere_pts(a1 + s[..., None] * d1, s1[..., 0],
                                  a2 + t[..., None] * d2, s2[..., 0]))


def _sphere_box_pts(center, radius, pb, mb, sb):
  """Sphere (center, radius) against box (pb, mb, half sizes sb); the
  normal points from the sphere toward the box, dist < 0 inside."""
  size = sb[..., :3]
  loc = _mtv(mb, center - pb)
  clamped = torch.minimum(torch.maximum(loc, -size), size)
  inside = (loc.abs() < size).all(-1)
  gaps = size - loc.abs()
  ax = torch.argmin(gaps, dim=-1)
  on_ax = torch.arange(3, device=loc.device) == ax[..., None]
  face = torch.where(on_ax, torch.sign(loc) * size, torch.zeros_like(loc))
  surf = torch.where(inside[..., None], torch.where(on_ax, face, loc),
                     clamped)
  closest = pb + _mv(mb, surf)
  dif = closest - center
  dc = math.norm_safe(dif)
  n_out = dif / torch.clamp(dc, min=_EPS)[..., None]
  n = torch.where(inside[..., None], -n_out, n_out)
  dist = torch.where(inside, -dc - radius, dc - radius)
  pos = center + n * (radius + 0.5 * dist)[..., None]
  return dist, pos, n


def _sphere_box(p1, m1, s1, p2, m2, s2):
  return _one(*_sphere_box_pts(p1, s1[..., 0], p2, m2, s2))


def _ternary(depth, like, iterations):
  """The segment parameter in [0, 1] (shaped like `like`) that minimizes
  depth(t), by `iterations` steps of ternary search, and the far end's
  parameter."""
  lo = torch.zeros_like(like)
  hi = torch.ones_like(like)
  for _ in range(iterations):
    t1 = lo + (hi - lo) / 3.0
    t2 = hi - (hi - lo) / 3.0
    go_right = depth(t1) > depth(t2)
    lo = torch.where(go_right, t1, lo)
    hi = torch.where(go_right, hi, t2)
  tb = 0.5 * (lo + hi)
  return tb, torch.where(tb > 0.5, 0.0, 1.0).to(tb.dtype)


def _capsule_box(p1, m1, s1, p2, m2, s2):
  a, b = _capsule_ends(p1, m1, s1)
  r = s1[..., 0]
  point = lambda t: a + t[..., None] * (b - a)
  tb, t_other = _ternary(
      lambda t: _sphere_box_pts(point(t), r, p2, m2, s2)[0], r, 12)
  return _stack([_sphere_box_pts(point(t), r, p2, m2, s2)
                 for t in (tb, t_other)])


def _box_box(p1, m1, s1, p2, m2, s2):
  corners1 = _box_corners(p1, m1, s1)
  corners2 = _box_corners(p2, m2, s2)
  e = lambda x: x[..., None, :]            # broadcast a box over its corners
  em = lambda x: x[..., None, :, :]

  def corner_depth(c, pb, mb, sb):
    return (_mtv(em(mb), c - e(pb)).abs() - e(sb[..., :3])).amax(-1)

  i2 = _lowest(corner_depth(corners2, p1, m1, s1), 4)
  i1 = _lowest(corner_depth(corners1, p2, m2, s2), 4)
  zero = p1.new_zeros(())
  o2 = _sphere_box_pts(_take(corners2, i2), zero, e(p1), em(m1), e(s1))
  o1 = _sphere_box_pts(_take(corners1, i1), zero, e(p2), em(m2), e(s2))
  return (torch.cat([o2[0], o1[0]], -1), torch.cat([o2[1], o1[1]], -2),
          torch.cat([-o2[2], o1[2]], -2))


# ---- convex meshes ----------------------------------------------------------


def _closest_on_tri(p, a, b, c):
  """Branchless closest point on triangle abc to p (Ericson 5.1.5)."""
  ab = b - a
  ac = c - a
  ap = p - a
  d1 = _dot(ab, ap)
  d2 = _dot(ac, ap)
  bp = p - b
  d3 = _dot(ab, bp)
  d4 = _dot(ac, bp)
  cp = p - c
  d5 = _dot(ab, cp)
  d6 = _dot(ac, cp)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  col = lambda x: x[..., None]
  where = lambda cond, x, y: torch.where(col(cond), x, y)

  # face interior
  denom = torch.clamp(va + vb + vc, min=_EPS)
  pt = a + col(vb / denom) * ab + col(vc / denom) * ac
  # edge BC
  t_bc = (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=_EPS)
  on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
  pt = where(on_bc, b + col(t_bc) * (c - b), pt)
  # edge AC
  t_ac = d2 / torch.clamp(d2 - d6, min=_EPS)
  on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
  pt = where(on_ac, a + col(t_ac) * ac, pt)
  # edge AB
  t_ab = d1 / torch.clamp(d1 - d3, min=_EPS)
  on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
  pt = where(on_ab, a + col(t_ab) * ab, pt)
  # vertices
  pt = where((d6 >= 0) & (d5 <= d6), c, pt)
  pt = where((d3 >= 0) & (d4 <= d3), b, pt)
  pt = where((d1 <= 0) & (d2 <= 0), a, pt)
  return pt


def _mesh_tables(verts: np.ndarray, faces: np.ndarray):
  """(triangles (F, 3, 3), outward face normals (F, 3), offsets (F,)),
  numpy float32."""
  tri = np.asarray(verts)[np.asarray(faces)]
  n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
  n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
  d = np.einsum("fi,fi->f", n, tri[:, 0])
  return (tri.astype(np.float32), n.astype(np.float32),
          d.astype(np.float32))


class MeshTables(NamedTuple):
  verts: torch.Tensor   # (V, 3)
  tri: torch.Tensor     # (F, 3, 3)
  fnorm: torch.Tensor   # (F, 3)
  foff: torch.Tensor    # (F,)


def mesh_tables(verts: np.ndarray, faces: np.ndarray, device) -> MeshTables:
  tri, fnorm, foff = _mesh_tables(verts, faces)
  t = lambda x: torch.as_tensor(x, device=device)
  return MeshTables(verts=t(np.array(verts, dtype=np.float32)),
                    tri=t(tri), fnorm=t(fnorm), foff=t(foff))


def _point_mesh_local(mt: MeshTables, c, radius):
  """Sphere (center c, radius) against the mesh, in mesh-local
  coordinates, with _sphere_box_pts's sign conventions."""
  tri = mt.tri.to(c.dtype)
  cp = _closest_on_tri(c[..., None, :], tri[:, 0], tri[:, 1], tri[:, 2])
  d2 = ((cp - c[..., None, :]) ** 2).sum(-1)                # (..., F)
  i = torch.argmin(d2, dim=-1)
  closest = _take(cp, i[..., None])[..., 0, :]
  dc = torch.sqrt(torch.clamp(torch.gather(d2, -1, i[..., None])[..., 0],
                              min=_EPS))
  inside = (math.fixed_vm(c, mt.fnorm.T.to(c.dtype)) - mt.foff < 0.0).all(-1)
  dif = closest - c
  n_out = dif / torch.clamp(dc, min=_EPS)[..., None]
  n = torch.where(inside[..., None], -n_out, n_out)
  dist = torch.where(inside, -dc - radius, dc - radius)
  pos = c + n * (radius + 0.5 * dist)[..., None]
  return dist, pos, n


def _mesh_fns(mt: MeshTables) -> Dict[Tuple[int, int], Callable]:
  """The pair functions of one mesh (the mesh is always geom 2)."""

  def point_world(pm, mm, point, radius):
    """World-frame sphere query against the mesh at pose (pm, mm)."""
    dist, pos_l, n_l = _point_mesh_local(mt, _mtv(mm, point - pm), radius)
    return dist, pm + _mv(mm, pos_l), _mv(mm, n_l)

  def world_verts(p, mat):
    return p[..., None, :] + math.fixed_mm(mt.verts.to(p.dtype),
                                           mat.transpose(-1, -2))

  def plane_mesh(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2]
    vw = world_verts(p2, m2)                                 # (..., V, 3)
    dists = _mv(vw, n) - _dot(p1, n)[..., None]
    idx = _lowest(dists, 4)
    d = torch.gather(dists, -1, idx)
    pos = _take(vw, idx) - 0.5 * d[..., None] * n[..., None, :]
    return d, pos, n[..., None, :].expand(pos.shape)

  def sphere_mesh(p1, m1, s1, p2, m2, s2):
    return _one(*point_world(p2, m2, p1, s1[..., 0]))

  def capsule_mesh(p1, m1, s1, p2, m2, s2):
    a, b = _capsule_ends(p1, m1, s1)
    r = s1[..., 0]
    point = lambda t: a + t[..., None] * (b - a)
    tb, t_other = _ternary(lambda t: point_world(p2, m2, point(t), r)[0],
                           r, 10)
    return _stack([point_world(p2, m2, point(t), r) for t in (tb, t_other)])

  def box_mesh(p1, m1, s1, p2, m2, s2):
    # mesh vertices into the box, box corners into the mesh (as box-box)
    e = lambda x: x[..., None, :]
    em = lambda x: x[..., None, :, :]
    zero = p1.new_zeros(())
    o2 = _sphere_box_pts(world_verts(p2, m2), zero, e(p1), em(m1), e(s1))
    i2 = _lowest(o2[0], 2)
    o1 = point_world(e(p2), em(m2), _box_corners(p1, m1, s1), zero)
    i1 = _lowest(o1[0], 2)
    pick = lambda o, i: (torch.gather(o[0], -1, i), _take(o[1], i),
                         _take(o[2], i))
    o2, o1 = pick(o2, i2), pick(o1, i1)
    return (torch.cat([o2[0], o1[0]], -1), torch.cat([o2[1], o1[1]], -2),
            torch.cat([-o2[2], o1[2]], -2))

  return {
      (GeomType.PLANE, GeomType.MESH): plane_mesh,
      (GeomType.SPHERE, GeomType.MESH): sphere_mesh,
      (GeomType.CAPSULE, GeomType.MESH): capsule_mesh,
      (GeomType.BOX, GeomType.MESH): box_mesh,
  }


# ---- heightfields -----------------------------------------------------------
# The geom collides against the local tangent plane of the bilinear height
# grid under it (height plus a central-difference normal): exact for
# terrain whose curvature is below the geom's radius. hdata is
# (B, nrow, ncol) and every query's leading axis is the env axis.


def _hf_height(hdata: torch.Tensor, size: torch.Tensor,
               x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Bilinear height (meters) at hfield-local (x, y), each (B, ...)."""
  B, nrow, ncol = hdata.shape
  cx = torch.clamp((x / size[0] + 1.0) * 0.5 * (ncol - 1), 0.0, ncol - 1.001)
  cy = torch.clamp((y / size[1] + 1.0) * 0.5 * (nrow - 1), 0.0, nrow - 1.001)
  x0 = torch.floor(cx).long()
  y0 = torch.floor(cy).long()
  fx, fy = cx - x0, cy - y0
  flat = hdata.reshape(B, -1)
  at = lambda r, c: torch.gather(flat, 1, (r * ncol + c).reshape(B, -1)
                                 ).reshape(x.shape)
  h00 = at(y0, x0)
  h01 = at(y0, x0 + 1)
  h10 = at(y0 + 1, x0)
  h11 = at(y0 + 1, x0 + 1)
  return ((1 - fy) * ((1 - fx) * h00 + fx * h01)
          + fy * ((1 - fx) * h10 + fx * h11))


def _hf_surface(hdata, size, loc):
  """(surface point, outward normal) in the hfield frame under loc."""
  nrow, ncol = hdata.shape[1], hdata.shape[2]
  ex = size[0] / (ncol - 1)
  ey = size[1] / (nrow - 1)
  x, y = loc[..., 0], loc[..., 1]
  # the point and its four neighbours for the central differences, in one
  # lookup
  h, hxp, hxm, hyp, hym = _hf_height(
      hdata, size, torch.stack([x, x + ex, x - ex, x, x], -1),
      torch.stack([y, y, y, y + ey, y - ey], -1)).unbind(-1)
  gx = (hxp - hxm) / (2 * ex)
  gy = (hyp - hym) / (2 * ey)
  n = torch.stack([-gx, -gy, torch.ones_like(gx)], -1)
  n = n / torch.clamp(math.norm_safe(n), min=_EPS)[..., None]
  return torch.stack([x, y, h], -1), n


def _hf_point(hdata, size, p1, m1, point, radius):
  """A sphere (point, radius) against the heightfield at pose (p1, m1)."""
  loc = _mtv(m1, point - p1)
  surf_l, n_l = _hf_surface(hdata, size, loc)
  n = _mv(m1, n_l)
  surf = p1 + _mv(m1, surf_l)
  dist = _dot(n, point - surf) - radius
  pos = point - n * (radius + 0.5 * dist)[..., None]
  return dist, pos, n


def _hfield_sphere(hdata, size):
  def fn(p1, m1, s1, p2, m2, s2):
    return _one(*_hf_point(hdata, size, p1, m1, p2, s2[..., 0]))
  return fn


def _hfield_capsule(hdata, size):
  def fn(p1, m1, s1, p2, m2, s2):
    ends = torch.stack(_capsule_ends(p2, m2, s2), -2)       # (..., 2, 3)
    return _hf_point(hdata, size, p1[..., None, :], m1[..., None, :, :],
                     ends, s2[..., 0:1])
  return fn


def _hfield_box(hdata, size):
  def fn(p1, m1, s1, p2, m2, s2):
    corners = _box_corners(p2, m2, s2)                       # (..., 8, 3)
    e = lambda x: x[..., None, :]
    em = lambda x: x[..., None, :, :]
    zero = p1.new_zeros(())
    d_all = _hf_point(hdata, size, e(p1), em(m1), corners, zero)[0]
    c = _take(corners, _lowest(d_all, 4))
    return _hf_point(hdata, size, e(p1), em(m1), c, zero)
  return fn


_HF_FNS = {
    (GeomType.HFIELD, GeomType.SPHERE): _hfield_sphere,
    (GeomType.HFIELD, GeomType.CAPSULE): _hfield_capsule,
    (GeomType.HFIELD, GeomType.BOX): _hfield_box,
}

_FNS = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.ELLIPSOID): _plane_ellipsoid,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.SPHERE, GeomType.ELLIPSOID): _sphere_sphere,  # approximation
    (GeomType.SPHERE, GeomType.BOX): _sphere_box,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
    (GeomType.CAPSULE, GeomType.BOX): _capsule_box,
    (GeomType.BOX, GeomType.BOX): _box_box,
}


# ---- plan and stage ---------------------------------------------------------


class Group(NamedTuple):
  key: Tuple[int, int]
  fn: Optional[Callable]   # None for heightfield classes (bound per step)
  g1: torch.Tensor         # (P,) geom ids
  g2: torch.Tensor


class Plan(NamedTuple):
  groups: Tuple[Group, ...]
  inv: torch.Tensor        # slot -> position in the groups' concatenation
  solref: torch.Tensor     # (ncon, 2) mixed on the host
  solimp: torch.Tensor     # (ncon, 5)
  slot_g1: torch.Tensor    # (ncon,) geom ids per slot
  slot_g2: torch.Tensor


def _mix(m: Model, g1: int, g2: int, geom: Dict[str, np.ndarray]):
  """(solref, solimp) of a pair, mixed as mj_contactParam does."""
  sm1, sm2 = geom["solmix"][g1], geom["solmix"][g2]
  mix = sm1 / max(sm1 + sm2, 1e-12)
  if sm1 < 1e-12 and sm2 < 1e-12:
    mix = 0.5
  elif sm1 < 1e-12:
    mix = 0.0
  elif sm2 < 1e-12:
    mix = 1.0
  p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
  if p1 != p2:
    mix = 1.0 if p1 > p2 else 0.0
  sr1, sr2 = geom["solref"][g1], geom["solref"][g2]
  if sr1[0] <= 0 or sr2[0] <= 0:
    solref = np.minimum(sr1, sr2)
  else:
    solref = mix * sr1 + (1 - mix) * sr2
  solimp = mix * geom["solimp"][g1] + (1 - mix) * geom["solimp"][g2]
  return solref, solimp


def slot_pairs(m: Model) -> np.ndarray:
  """(ncon_max, 4): the pair table's row [geom1, geom2, slots, condim] of
  each contact slot."""
  pairs = m.collision_pairs
  return np.repeat(pairs, pairs[:, 2], axis=0)


def make_plan(m: Model) -> Plan:
  """Pairs grouped by class, the slot order, and the contact parameters
  that depend on the model alone (solref, solimp), mixed on the host.
  Friction, margin and gap are gathered from the Model at each step."""
  dev = m.device
  idx = lambda x: index_tensor(x, dev)
  geom = {k: getattr(m, "geom_" + k).detach().cpu().numpy()
          for k in ("solref", "solimp", "solmix")}
  entries: Dict[Tuple[int, int, int], list] = {}
  slot = 0
  solref, solimp = [], []
  for p in m.collision_pairs:
    g1, g2, nslots = int(p[0]), int(p[1]), int(p[2])
    t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
    # mesh pairs group per mesh: each mesh has its own tables
    did = int(m.geom_dataid[g2]) if t2 == GeomType.MESH else -1
    entries.setdefault((t1, t2, did), []).append((g1, g2, slot, nslots))
    sr, si = _mix(m, g1, g2, geom)
    solref += [sr] * nslots
    solimp += [si] * nslots
    slot += nslots

  meshes: Dict[int, MeshTables] = {}
  groups, order = [], []
  for (t1, t2, did), es in entries.items():
    key = (GeomType(t1), GeomType(t2))
    if t2 == GeomType.MESH:
      if did not in meshes:
        meshes[did] = mesh_tables(m.mesh_vert[did], m.mesh_face[did], dev)
      fn = _mesh_fns(meshes[did])[key]
    elif key in _HF_FNS:
      fn = None
    else:
      fn = _FNS[key]
    groups.append(Group(key=key, fn=fn, g1=idx([e[0] for e in es]),
                        g2=idx([e[1] for e in es])))
    order += [s for e in es for s in range(e[2], e[2] + e[3])]
  f32 = lambda x, w: torch.as_tensor(
      np.asarray(x, dtype=np.float32).reshape(-1, w), device=dev)
  slots = slot_pairs(m)
  return Plan(groups=tuple(groups), inv=idx(np.argsort(order)),
              solref=f32(solref, 2), solimp=f32(solimp, 5),
              slot_g1=idx(slots[:, 0]), slot_g2=idx(slots[:, 1]))


def collision(m: Model, d: Data) -> Data:
  """Fill the fixed-capacity contact set: one batched call per class. The
  geoms' sizes and frictions may carry a leading env axis (a per-env
  model)."""
  if m.ncon_max == 0:
    return d
  plan: Plan = m.plan["collision"]
  B, ncon = d.batch, m.ncon_max
  dists, poss, frames = [], [], []
  for group in plan.groups:
    g1, g2 = group.g1, group.g2
    size = lambda g: m.geom_size[..., g, :].expand(B, -1, -1)
    fn = group.fn or _HF_FNS[group.key](d.hfield_data, m.hfield_size)
    dd, pp, nn = fn(
        d.geom_xpos[:, g1], d.geom_xmat[:, g1], size(g1),
        d.geom_xpos[:, g2], d.geom_xmat[:, g2], size(g2))
    dists.append(dd.reshape(B, -1))
    poss.append(pp.reshape(B, -1, 3))
    frames.append(_make_frame(nn).reshape(B, -1, 3, 3))
  inv = plan.inv
  dist = torch.cat(dists, 1)[:, inv]
  pos = torch.cat(poss, 1)[:, inv]
  frame = torch.cat(frames, 1)[:, inv]

  # friction, margin and gap follow the Model's tensors
  sg1, sg2 = plan.slot_g1, plan.slot_g2
  fr = torch.maximum(m.geom_friction[..., sg1, :],
                     m.geom_friction[..., sg2, :])
  friction = torch.stack([fr[..., 0], fr[..., 0], fr[..., 1], fr[..., 2],
                          fr[..., 2]], -1)
  margin = torch.maximum(m.geom_margin[sg1], m.geom_margin[sg2])
  gap = torch.maximum(m.geom_gap[sg1], m.geom_gap[sg2])
  includemargin = (margin - gap).expand(B, ncon)
  contact = d.contact.replace(
      dist=dist, pos=pos, frame=frame, includemargin=includemargin,
      friction=friction.expand(B, ncon, 5),
      solref=plan.solref.expand(B, ncon, 2),
      solimp=plan.solimp.expand(B, ncon, 5))
  ncon_active = (dist < includemargin).sum(-1, dtype=torch.int32)
  return d.replace(contact=contact, ncon_active=ncon_active)

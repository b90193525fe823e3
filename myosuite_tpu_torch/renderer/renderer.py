"""Batched offscreen rendering on the device, with no GL and no MuJoCo.

The JAX package's renderer rasterizes one env at a time through MuJoCo's
GL (`mujoco.Renderer` over a host `MjModel`). This one casts a ray through
the centre of every pixel of every env of a batch at once, in plain
PyTorch, against the geoms at the poses `kinematics` gives the state's
qpos and mocap (as the JAX renderer's `mj_forward` sync does):
- planes, spheres, capsules, ellipsoids, cylinders and boxes by their
  analytic hits;
- the meshes of `Model.mesh_vert` / `mesh_face` by a ray-triangle test
  over chunks of faces;
- the heightfield of each env (`Data.hfield_data`) as two triangles per
  grid cell, walked cell by cell along each ray (its top surface only).

Geoms keep a running nearest hit, so memory grows with the rays, never
with rays x geoms. Groups 3-5 are hidden, as in MuJoCo's default
`mjvOption`, and so are geoms of alpha 0. Hits nearer than znear or
farther than zfar (MuJoCo's clipping planes) are dropped.

Outputs, batch-first: rgb (B, H, W, 3) uint8 is geom_rgba under a
headlight at the camera (Lambert: AMBIENT + DIFFUSE |n . ray|) on black;
depth (B, H, W) float32 is the distance along the camera's axis, zfar
where no geom is hit, as `mujoco.Renderer` gives it; segmentation (B, H,
W, 2) int32 is (geom id, mjOBJ_GEOM = 5), (-1, -1) where no geom is hit.
MuJoCo's pixels differ: it adds shadows, specular light, materials,
tendons and sites.

Every sum runs in an order fixed by the geometry, never by the batch, so
an env rendered alone is bit-equal to its row of a batch.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.physics import kinematics as kin_mod
from myosuite_tpu_torch.physics import math
from myosuite_tpu_torch.physics.types import (RENDER_FIELDS, Data, GeomType,
                                              Model)

AMBIENT = 0.3
DIFFUSE = 0.7
HIDDEN_GROUPS = (3, 4, 5)
OBJ_GEOM = 5              # mjtObj.mjOBJ_GEOM
CAM_FIXED = 0             # mjtCamLight.mjCAMLIGHT_FIXED
FACE_CHUNK = 32           # mesh triangles per pass
RAYS_PER_PASS = 1 << 24   # rays cast at once; larger batches go in chunks
HFIELD_CHECK = 16         # heightfield cells walked between two exit tests


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return math.fixed_sum(a * b, -1)


def _first_root(o, d, r):
  """Nearest t > 0 where |o + t d| = r, over the last axis (2 or 3), and
  the hit point; inf where the ray misses. The closest-approach form keeps
  the discriminant free of the b^2 - ac cancellation."""
  a = _dot(d, d)
  tc = -_dot(o, d) / a
  p = o + tc[..., None] * d
  disc = r * r - _dot(p, p)
  t = tc - torch.sqrt(torch.clamp(disc, min=0.0) / a)
  t = torch.where((disc >= 0.0) & (t > 0.0), t, torch.full_like(t, np.inf))
  return t, o + t[..., None] * d


def _nearest(*hits):
  """The nearest of several (t, normal) pairs, elementwise."""
  t, n = hits[0]
  for t2, n2 in hits[1:]:
    closer = t2 < t
    t = torch.where(closer, t2, t)
    n = torch.where(closer[..., None], n2, n)
  return t, n


def _unit(axis: int, like: torch.Tensor, sign) -> torch.Tensor:
  e = torch.zeros_like(like)
  e[..., axis] = 1.0
  return e * sign


def _sphere(o, d, size):
  return _first_root(o, d, size[..., 0])


def _ellipsoid(o, d, size):
  s = size[..., :3]
  t, _ = _first_root(o / s, d / s, torch.ones_like(size[..., 0]))
  p = o + t[..., None] * d
  return t, p / (s * s)


def _capsule(o, d, size):
  r, h = size[..., 0], size[..., 1]
  t_side, p2 = _first_root(o[..., :2], d[..., :2], r)
  z = o[..., 2] + t_side * d[..., 2]
  t_side = torch.where(z.abs() <= h, t_side, torch.full_like(t_side, np.inf))
  n_side = torch.cat([p2, torch.zeros_like(z)[..., None]], -1)
  hits = [(t_side, n_side)]
  for s in (1.0, -1.0):
    c = torch.stack([torch.zeros_like(h), torch.zeros_like(h), s * h], -1)
    t, p = _first_root(o - c, d, r)
    hits.append((t, p))
  return _nearest(*hits)


def _cylinder(o, d, size):
  r, h = size[..., 0], size[..., 1]
  t_side, p2 = _first_root(o[..., :2], d[..., :2], r)
  z = o[..., 2] + t_side * d[..., 2]
  t_side = torch.where(z.abs() <= h, t_side, torch.full_like(t_side, np.inf))
  hits = [(t_side, torch.cat([p2, torch.zeros_like(z)[..., None]], -1))]
  dz = _safe(d[..., 2])
  for s in (1.0, -1.0):
    t = (s * h - o[..., 2]) / dz
    q = o[..., :2] + t[..., None] * d[..., :2]
    ok = (t > 0.0) & (_dot(q, q) <= r * r)
    hits.append((torch.where(ok, t, torch.full_like(t, np.inf)),
                 _unit(2, o, s).expand_as(o)))
  return _nearest(*hits)


def _safe(x: torch.Tensor) -> torch.Tensor:
  """x with exact zeros moved to a tiny value of either sign (1 / x
  finite)."""
  return torch.where(x == 0.0, torch.full_like(x, 1e-30), x)


def _box(o, d, size):
  s = size[..., :3]
  inv = 1.0 / _safe(d)
  t1 = (-s - o) * inv
  t2 = (s - o) * inv
  tlo = torch.minimum(t1, t2)
  thi = torch.maximum(t1, t2)
  near = torch.maximum(torch.maximum(tlo[..., 0], tlo[..., 1]), tlo[..., 2])
  far = torch.minimum(torch.minimum(thi[..., 0], thi[..., 1]), thi[..., 2])
  ok = (near <= far) & (near > 0.0)
  t = torch.where(ok, near, torch.full_like(near, np.inf))
  n = torch.zeros_like(o)
  for k in (2, 1, 0):      # the entering face; x wins a tie, then y
    on = (tlo[..., k] == near)[..., None]
    n = torch.where(on, _unit(k, o, 1.0) * -torch.sign(d[..., k:k + 1]), n)
  return t, n


def _plane(o, d, size):
  dz = _safe(d[..., 2])
  t = -o[..., 2] / dz
  x = o[..., 0] + t * d[..., 0]
  y = o[..., 1] + t * d[..., 1]
  sx, sy = size[..., 0], size[..., 1]
  inside = ((sx <= 0.0) | (sy <= 0.0)) | ((x.abs() <= sx) & (y.abs() <= sy))
  ok = (t > 0.0) & inside
  return (torch.where(ok, t, torch.full_like(t, np.inf)),
          _unit(2, o, 1.0).expand_as(o))


def _triangles(o, d, v0, e1, e2):
  """Moller-Trumbore of rays (..., 1, 3) against triangles (F, 3) or
  (..., F, 3): nearest t > 0 over the triangles (inf where none) and that
  triangle's index."""
  pvec = math.cross(d, e2)
  det = _dot(e1, pvec)
  inv = 1.0 / _safe(det)
  tvec = o - v0
  u = _dot(tvec, pvec) * inv
  qvec = math.cross(tvec, e1)
  v = _dot(d, qvec) * inv
  t = _dot(e2, qvec) * inv
  ok = (det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
  t = torch.where(ok, t, torch.full_like(t, np.inf))
  return torch.min(t, -1)


def _mesh(o, d, tri):
  """Rays (B, P, 3) against one mesh's triangles (F, 3, 3), FACE_CHUNK at
  a time: nearest t and the face normal there."""
  best = torch.full(o.shape[:-1], np.inf, dtype=o.dtype, device=o.device)
  normal = torch.zeros_like(o)
  for lo in range(0, tri.shape[0], FACE_CHUNK):
    c = tri[lo:lo + FACE_CHUNK]
    v0, e1, e2 = c[:, 0], c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]
    t, i = _triangles(o[..., None, :], d[..., None, :], v0, e1, e2)
    fn = math.cross(e1, e2)[i]
    closer = t < best
    best = torch.where(closer, t, best)
    normal = torch.where(closer[..., None], fn, normal)
  return best, normal


def _hfield(o, d, hdata, size):
  """Rays (B, P, 3), hfield-local, against each env's grid (B, nrow, ncol)
  of heights over [-size[0], size[0]] x [-size[1], size[1]]: a cell-by-cell
  walk (Amanatides-Woo) of the cells each ray crosses inside the grid's
  box, testing both triangles of each (corners (c, r), (c+1, r), (c+1, r+1)
  and (c, r), (c+1, r+1), (c, r+1))."""
  B, nrow, ncol = hdata.shape
  sx, sy = size[0], size[1]
  dx, dy = 2.0 * sx / (ncol - 1), 2.0 * sy / (nrow - 1)
  zmin = hdata.reshape(B, -1).amin(1)[:, None]
  zmax = hdata.reshape(B, -1).amax(1)[:, None]
  inv = 1.0 / _safe(d)
  # the ray's span inside the grid's box
  spans = []
  for k, (a, b) in enumerate(((-sx, sx), (-sy, sy), (zmin, zmax))):
    t1 = (a - o[..., k]) * inv[..., k]
    t2 = (b - o[..., k]) * inv[..., k]
    spans.append((torch.minimum(t1, t2), torch.maximum(t1, t2)))
  t0 = torch.clamp(torch.maximum(torch.maximum(spans[0][0], spans[1][0]),
                                 spans[2][0]), min=0.0)
  t1 = torch.minimum(torch.minimum(spans[0][1], spans[1][1]), spans[2][1])
  live = t0 <= t1
  start = o + t0[..., None] * d
  col = torch.clamp(torch.floor((start[..., 0] + sx) / dx), 0, ncol - 2).long()
  row = torch.clamp(torch.floor((start[..., 1] + sy) / dy), 0, nrow - 2).long()
  step_c = torch.where(d[..., 0] >= 0.0, 1, -1)
  step_r = torch.where(d[..., 1] >= 0.0, 1, -1)
  # t of the next column and row boundary, and t across one cell
  next_x = -sx + (col + (step_c > 0).long()).to(o.dtype) * dx
  next_y = -sy + (row + (step_r > 0).long()).to(o.dtype) * dy
  tmax_c = (next_x - o[..., 0]) * inv[..., 0]
  tmax_r = (next_y - o[..., 1]) * inv[..., 1]
  tdel_c = (dx * inv[..., 0]).abs()
  tdel_r = (dy * inv[..., 1]).abs()
  flat = hdata.reshape(B, -1)
  benv = torch.arange(B, device=o.device)[:, None] * (nrow * ncol)
  best = torch.full_like(t0, np.inf)
  normal = torch.zeros_like(o)
  for it in range(nrow + ncol):
    if it % HFIELD_CHECK == 0 and not bool(live.any()):
      break
    corner = lambda r, c: torch.stack([
        -sx + c.to(o.dtype) * dx, -sy + r.to(o.dtype) * dy,
        flat.reshape(-1)[benv + r * ncol + c]], -1)
    v00 = corner(row, col)
    v10 = corner(row, col + 1)
    v11 = corner(row + 1, col + 1)
    v01 = corner(row + 1, col)
    for a, b in ((v10, v11), (v11, v01)):
      e1, e2 = a - v00, b - v00
      t, _ = _triangles(o[..., None, :], d[..., None, :], v00[..., None, :],
                        e1[..., None, :], e2[..., None, :])
      closer = live & (t < best)
      best = torch.where(closer, t, best)
      normal = torch.where(closer[..., None], math.cross(e1, e2), normal)
    # step into the next cell; a ray leaves once past its span or a hit
    go_c = tmax_c < tmax_r
    t_here = torch.where(go_c, tmax_c, tmax_r)
    col = torch.where(go_c, col + step_c, col)
    row = torch.where(go_c, row, row + step_r)
    tmax_c = torch.where(go_c, tmax_c + tdel_c, tmax_c)
    tmax_r = torch.where(go_c, tmax_r, tmax_r + tdel_r)
    live = (live & (t_here <= t1) & (best > t_here) & (col >= 0)
            & (col <= ncol - 2) & (row >= 0) & (row <= nrow - 2))
    col = torch.clamp(col, 0, ncol - 2)
    row = torch.clamp(row, 0, nrow - 2)
  return best, normal


_ANALYTIC = {GeomType.PLANE: _plane, GeomType.SPHERE: _sphere,
             GeomType.CAPSULE: _capsule, GeomType.ELLIPSOID: _ellipsoid,
             GeomType.CYLINDER: _cylinder, GeomType.BOX: _box}


def camera_names(model: Model) -> List[str]:
  return [str(n) for n in model.render.get("cam_names", ())]


class Renderer:
  """Offscreen renderer of an env's model (or of a `Model`); `render`
  draws a whole batch."""

  def __init__(self, env, width: int = 640, height: int = 480):
    self._model = m = env if isinstance(env, Model) else env.model
    self.width, self.height = int(width), int(height)
    missing = [k for k in RENDER_FIELDS if k not in m.render]
    if missing:
      raise ValueError(
          f"the model has none of the render fields {missing}: its model "
          "file predates them; export it afresh "
          "(tests/torch_common.py::write_export)")
    r = m.render
    dev = m.device
    self._rgba = torch.as_tensor(r["geom_rgba"], device=dev)
    self._geoms = [g for g in range(m.ngeom)
                   if int(r["geom_group"][g]) not in HIDDEN_GROUPS
                   and float(r["geom_rgba"][g, 3]) > 0.0]
    self._tri = {}
    for g in self._geoms:
      if int(m.geom_type[g]) == GeomType.MESH:
        i = int(m.geom_dataid[g])
        v = np.asarray(m.mesh_vert[i], dtype=np.float32)
        self._tri[g] = torch.as_tensor(v[np.asarray(m.mesh_face[i])],
                                       device=dev)

  def close(self):
    pass

  def _camera(self, d: Data, camera: Optional[str]):
    """(origin, right, up, forward) each (B, 3), and fovy in degrees."""
    r = self._model.render
    B, dev = d.batch, d.qpos.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    if camera is None:
      az, el = (np.deg2rad(float(r["free_azimuth"])),
                np.deg2rad(float(r["free_elevation"])))
      fwd = f32([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                 np.sin(el)])
      up = f32([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az),
                np.cos(el)])
      pos = f32(r["free_lookat"]) - float(r["free_distance"]) * fwd
      right = math.cross(fwd, up)
      ex = lambda v: v.expand(B, 3)
      return ex(pos), ex(right), ex(up), ex(fwd), float(r["vis_fovy"])
    names = camera_names(self._model)
    if camera not in names:
      raise KeyError(f"no camera {camera!r}; the model's cameras are "
                     f"{names}")
    i = names.index(camera)
    if int(r["cam_mode"][i]) != CAM_FIXED:
      raise ValueError(f"camera {camera!r}: only fixed cameras are drawn "
                       f"(mode {int(r['cam_mode'][i])})")
    b = int(r["cam_bodyid"][i])
    xmat = d.xmat[:, b]
    pos = d.xpos[:, b] + math.fixed_mv(xmat, f32(r["cam_pos"][i]))
    rot = math.fixed_mm(xmat, math.quat_to_mat(f32(r["cam_quat"][i])))
    return (pos, rot[..., 0], rot[..., 1], -rot[..., 2],
            float(r["cam_fovy"][i]))

  def _rays(self, d: Data, camera: Optional[str]):
    """Ray origins (B, 1, 3) and directions (B, H*W, 3), each direction's
    component along the camera's axis 1, so a hit's t is its depth."""
    pos, right, up, fwd, fovy = self._camera(d, camera)
    dev, dt = pos.device, pos.dtype
    h, w = self.height, self.width
    tan = float(np.tan(np.deg2rad(fovy) / 2.0))
    u = ((2.0 * (torch.arange(w, device=dev, dtype=dt) + 0.5) / w - 1.0)
         * tan * (w / h))
    v = (1.0 - 2.0 * (torch.arange(h, device=dev, dtype=dt) + 0.5) / h) * tan
    dirs = (fwd[:, None, None, :]
            + u[None, None, :, None] * right[:, None, None, :]
            + v[None, :, None, None] * up[:, None, None, :])
    return pos[:, None, :], dirs.reshape(d.batch, h * w, 3)

  def _cast(self, d: Data, camera: Optional[str]):
    """Nearest hit of every pixel: (t (B, P), geom id (B, P), world normal
    (B, P, 3)); t inf and id -1 where no geom is hit."""
    m = self._model
    o, dirs = self._rays(d, camera)
    r = m.render
    znear, zfar = float(r["vis_znear"]), float(r["vis_zfar"])
    B, P = dirs.shape[:2]
    best = torch.full((B, P), np.inf, dtype=dirs.dtype, device=dirs.device)
    gid = torch.full((B, P), -1, dtype=torch.int32, device=dirs.device)
    normal = torch.zeros_like(dirs)
    for g in self._geoms:
      gt = int(m.geom_type[g])
      p = d.geom_xpos[:, g][:, None]                   # (B, 1, 3)
      rot = d.geom_xmat[:, g][:, None]                 # (B, 1, 3, 3)
      ol = math.fixed_vm(o - p, rot)                   # R^T (o - p)
      dl = math.fixed_vm(dirs, rot)
      if gt == GeomType.MESH:
        t, nl = _mesh(ol, dl, self._tri[g])
      elif gt == GeomType.HFIELD:
        t, nl = _hfield(ol, dl, d.hfield_data, m.hfield_size)
      elif gt in _ANALYTIC:
        t, nl = _ANALYTIC[GeomType(gt)](ol, dl, m.geom_size[g])
      else:
        continue
      closer = (t < best) & (t >= znear) & (t <= zfar)
      best = torch.where(closer, t, best)
      gid = torch.where(closer, torch.full_like(gid, g), gid)
      normal = torch.where(closer[..., None], math.fixed_mv(rot, nl), normal)
    return best, gid, normal, dirs, zfar

  def render(self, data: Data, camera: Optional[str] = None,
             depth: bool = False, segmentation: bool = False
             ) -> torch.Tensor:
    """rgb (B, H, W, 3) uint8, or depth (B, H, W) float32, or
    segmentation (B, H, W, 2) int32, of every env of `data` on its
    device; camera None is MuJoCo's default free camera, else a fixed
    camera's name."""
    per = max(1, RAYS_PER_PASS // (self.width * self.height))
    B = data.batch
    if B > per:
      return torch.cat([self.render(_pose_rows(data, slice(lo, lo + per)),
                                    camera, depth, segmentation)
                        for lo in range(0, B, per)])
    d = kin_mod.kinematics(self._model, data)
    t, gid, n, dirs, zfar = self._cast(d, camera)
    shape = (B, self.height, self.width)
    hit = gid >= 0
    if depth:
      return torch.where(hit, t, torch.full_like(t, zfar)).reshape(shape)
    if segmentation:
      kind = torch.where(hit, torch.full_like(gid, OBJ_GEOM),
                         torch.full_like(gid, -1))
      return torch.stack([gid, kind], -1).reshape(shape + (2,))
    cos = (_dot(n, dirs) / torch.sqrt(_dot(n, n) * _dot(dirs, dirs))).abs()
    light = AMBIENT + DIFFUSE * torch.nan_to_num(cos)
    color = self._rgba[torch.clamp(gid, min=0).long(), :3] * light[..., None]
    rgb = torch.floor(torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5)
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    return rgb.to(torch.uint8).reshape(shape + (3,))


def _pose_rows(d: Data, rows: slice) -> Data:
  """The rows of d that posing and drawing read."""
  return d.replace(qpos=d.qpos[rows], mocap_pos=d.mocap_pos[rows],
                   mocap_quat=d.mocap_quat[rows],
                   hfield_data=d.hfield_data[rows])


def pose_data(model: Model, qpos: torch.Tensor,
              mocap_pos: Optional[torch.Tensor] = None,
              mocap_quat: Optional[torch.Tensor] = None,
              hfield: Optional[torch.Tensor] = None) -> Data:
  """A Data of T = qpos.shape[0] envs holding just what `render` reads:
  the qpos (T, nq); the mocap poses (T, nmocap, .), by default each mocap
  body's model pose (MuJoCo's reset); the heightfield (T, nrow, ncol) or
  one grid for every row, by default flat."""
  T = qpos.shape[0]
  d = physics_io.make_data(model, T, qpos.device)
  kw = {"qpos": qpos.to(torch.float32)}
  if model.nmocap:
    bodies = np.nonzero(np.asarray(model.body_mocapid) >= 0)[0]
    order = np.argsort(np.asarray(model.body_mocapid)[bodies])
    bodies = torch.as_tensor(bodies[order], device=qpos.device)
    kw["mocap_pos"] = (model.body_pos[bodies].expand(T, -1, -1).clone()
                       if mocap_pos is None else mocap_pos)
    kw["mocap_quat"] = (model.body_quat[bodies].expand(T, -1, -1).clone()
                        if mocap_quat is None else mocap_quat)
  if hfield is not None:
    kw["hfield_data"] = hfield.expand(T, -1, -1) if hfield.dim() == 2 \
        else hfield
  return d.replace(**kw)


def save_video(path: str, frames: np.ndarray, fps: int) -> str:
  """Write (T, H, W, 3) uint8 frames with imageio (imported here): a .gif
  through its pillow plugin, any other file through ffmpeg."""
  import imageio
  if path.lower().endswith(".gif"):
    imageio.mimsave(path, list(frames), duration=1000.0 / fps)
  else:
    imageio.mimsave(path, list(frames), fps=fps)
  return path


def render_rollout(env, datas: Iterable[Data], path: str, fps: int = 50,
                   camera: Optional[str] = None) -> str:
  """A video of env 0 of each Data of a rollout (a batch of one is the
  JAX package's single-env rollout), drawn as one batch."""
  datas = list(datas)
  cat = lambda f: torch.cat([getattr(d, f)[:1] for d in datas])
  d = pose_data(env.model, cat("qpos"), cat("mocap_pos"), cat("mocap_quat"),
                cat("hfield_data"))
  return save_video(path, Renderer(env).render(d, camera=camera).cpu()
                    .numpy(), fps)


def render_qpos_sequence(env, qpos_seq, path: str, fps: int = 50,
                         camera: Optional[str] = None) -> str:
  """A video of a (T, nq) qpos sequence, drawn as a batch of T (the mocap
  bodies at their model poses, flat terrain)."""
  m = env.model
  d = pose_data(m, torch.as_tensor(np.array(qpos_seq), dtype=torch.float32,
                                   device=m.device))
  return save_video(path, Renderer(env).render(d, camera=camera).cpu()
                    .numpy(), fps)


class PassiveViewer:
  """Interactive onscreen viewer of one row of a batch, in a
  `mujoco.viewer` window (the JAX package's `PassiveViewer`): SPACE
  pauses. The env's host `mj_model` and an `MjData` are only the window's
  drawing target; the dynamics stay on the device.

  Needs a display and MuJoCo: on Linux without DISPLAY it raises
  RuntimeError (GLFW would abort the process), without MuJoCo an
  ImportError. Callers fall back to offscreen.
  """

  def __init__(self, env, realtime: bool = True):
    import os
    import sys
    if sys.platform.startswith("linux") and not os.environ.get("DISPLAY"):
      raise RuntimeError("no DISPLAY; onscreen viewer needs an X display")
    mujoco = physics_io.import_mujoco()
    import mujoco.viewer
    self._mujoco = mujoco
    self._mj_model = env.mj_model
    self._mj_data = mujoco.MjData(self._mj_model)
    self._dt = float(env.dt) if hasattr(env, "dt") else 0.02
    self._realtime = realtime
    self._paused = False
    self._viewer = mujoco.viewer.launch_passive(
        self._mj_model, self._mj_data, key_callback=self._on_key)

  def _on_key(self, keycode):
    if keycode == 32:  # SPACE: toggle pause
      self._paused = not self._paused

  def is_running(self) -> bool:
    return self._viewer.is_running()

  def sync(self, data, row: int = 0) -> None:
    """Show row `row` of a batched Data: its qpos, qvel and mocap poses are
    copied to the host and `mj_forward`ed; blocks while paused, and paces
    at the env's dt when realtime."""
    import time
    host = lambda x: x[row].detach().cpu().numpy().astype(np.float64)
    d = self._mj_data
    d.qpos[:] = host(data.qpos)
    d.qvel[:] = host(data.qvel)
    n = self._mj_model.nmocap
    if n:
      d.mocap_pos[:] = host(data.mocap_pos)[:n]
      d.mocap_quat[:] = host(data.mocap_quat)[:n]
    self._mujoco.mj_forward(self._mj_model, d)
    self._viewer.sync()
    while self._paused and self._viewer.is_running():
      time.sleep(0.05)
      self._viewer.sync()
    if self._realtime:
      time.sleep(self._dt)

  def close(self):
    self._viewer.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

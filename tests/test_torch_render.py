"""The port's renderer, visual observations and rendering tools on the CPU,
and the batch-invariant products of the C5 repair.

The renderer is held against a float64 numpy ray caster written here
(the standard quadratic and slab formulas, and every heightfield triangle
by brute force, where the port walks the grid cell by cell) on a small
scene with every geom class, at the geom poses the port's kinematics
gives. The ResNet trunk is held against the JAX package's flax trunk on
the same parameters, converted. Tolerances are stated in each test.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import myosuite_tpu
import myosuite_tpu_torch
from myosuite_tpu.envs import visual_nets as jvisual_nets
from myosuite_tpu.utils import html as jhtml
from myosuite_tpu_torch.envs import gym_adapter, visual, visual_nets
from myosuite_tpu_torch.envs.registry import ASSETS
from myosuite_tpu_torch.logger import examine_logs, trace
from myosuite_tpu_torch.physics import io as pio
from myosuite_tpu_torch.physics import kinematics, math
from myosuite_tpu_torch.renderer import (PassiveViewer, Renderer,
                                         render_qpos_sequence,
                                         render_rollout)
from myosuite_tpu_torch.train import convert
from myosuite_tpu_torch.utils import examine_env, examine_sim, html
from myosuite_tpu_torch.utils import render_cams

# every geom class the port draws; a hidden sphere (group 3) in front of
# the box; a free box carrying a camera; all collisions off
SCENE_XML = """
<mujoco>
  <option timestep="0.002" iterations="6" ls_iterations="6"/>
  <visual><global fovy="50"/></visual>
  <asset>
    <mesh name="tet" vertex="0 0 0  .16 0 0  0 .16 0  0 0 .16"/>
    <hfield name="terrain" nrow="6" ncol="8" size=".5 .3 .1 .05"/>
  </asset>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <geom type="plane" size="1.5 1.5 .1" pos="0 0 -.35" rgba=".4 .5 .6 1"/>
    <geom type="hfield" hfield="terrain" pos="0 -.9 -.3" rgba=".3 .7 .3 1"/>
    <geom type="sphere" size=".1" pos=".45 0 0" rgba="1 0 0 1"/>
    <geom type="capsule" size=".06 .12" pos="-.45 .05 0" euler=".2 .5 .3"
          rgba="0 1 0 1"/>
    <geom type="ellipsoid" size=".14 .08 .05" pos="0 .45 .02"
          euler=".3 .2 .1" rgba="0 0 1 1"/>
    <geom type="cylinder" size=".08 .1" pos=".05 -.45 .05" euler=".6 0 .2"
          rgba="1 1 0 1"/>
    <geom type="mesh" mesh="tet" pos=".35 .35 .05" euler=".1 .2 .3"
          rgba="1 0 1 1"/>
    <geom type="sphere" size=".05" pos="0 0 .45" group="3"/>
    <body name="box" pos="0 0 .2">
      <freejoint/>
      <geom type="box" size=".1 .07 .05" rgba=".8 .8 .8 1"/>
      <camera name="boxcam" pos="0 -1.2 .6" xyaxes="1 0 0 0 .45 .9"/>
    </body>
    <camera name="top" pos="0 .05 2.2"/>
  </worldbody>
</mujoco>
"""
H, W = 48, 64
HIDDEN = 7          # the group-3 sphere's geom id


@pytest.fixture(scope="module")
def scene():
  """(port Model, Data of 3 envs posed by the port's kinematics): the box
  at three poses, each env its own heightfield."""
  m = pio.put_model(SCENE_XML, "cpu")
  rng = np.random.default_rng(0)
  d = pio.make_data(m, 3)
  q = d.qpos.clone()
  q[:, :3] = torch.as_tensor(rng.uniform(-0.1, 0.1, (3, 3)) + [0, 0, 0.2],
                             dtype=torch.float32)
  quat = rng.normal(size=(3, 4))
  q[:, 3:7] = torch.as_tensor(quat / np.linalg.norm(quat, axis=1,
                                                    keepdims=True),
                              dtype=torch.float32)
  hf = torch.as_tensor(rng.uniform(0.0, 0.1, (3, 6, 8)), dtype=torch.float32)
  d = kinematics.kinematics(m, d.replace(qpos=q, hfield_data=hf))
  return m, d


# ---- a float64 reference ray caster ----------------------------------------

def _quat_mat(q):
  w, x, y, z = q
  return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                    2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)]])


def _camera64(m, d, env, camera):
  """(origin, right, up, forward, fovy) in float64."""
  r = m.render
  if camera is None:
    az, el = np.deg2rad(float(r["free_azimuth"])), np.deg2rad(
        float(r["free_elevation"]))
    fwd = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                    np.sin(el)])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az),
                   np.cos(el)])
    pos = r["free_lookat"].astype(np.float64) - float(
        r["free_distance"]) * fwd
    return pos, np.cross(fwd, up), up, fwd, float(r["vis_fovy"])
  i = [str(n) for n in r["cam_names"]].index(camera)
  b = int(r["cam_bodyid"][i])
  xpos = d.xpos[env, b].double().numpy()
  xmat = d.xmat[env, b].double().numpy()
  rot = xmat @ _quat_mat(r["cam_quat"][i].astype(np.float64))
  pos = xpos + xmat @ r["cam_pos"][i].astype(np.float64)
  return pos, rot[:, 0], rot[:, 1], -rot[:, 2], float(r["cam_fovy"][i])


def _tri_hits(o, d, tri):
  """Nearest t > 0 of rays (P, 3) over triangles (F, 3, 3) (inf if none),
  by the plane of each triangle and its barycentric coordinates."""
  v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
  n = np.cross(v1 - v0, v2 - v0)                         # (F, 3)
  denom = d @ n.T                                        # (P, F)
  with np.errstate(divide="ignore", invalid="ignore"):
    t = ((v0 * n).sum(-1)[None] - o @ n.T) / denom
  p = o[:, None] + t[..., None] * d[:, None]              # (P, F, 3)
  inside = np.ones_like(t, dtype=bool)
  for a, b in ((v0, v1), (v1, v2), (v2, v0)):
    inside &= (np.cross(b - a, p - a) * n).sum(-1) >= 0
  t = np.where(inside & (t > 0) & np.isfinite(t), t, np.inf)
  return t.min(-1)


def _quadric(o, d, r):
  """Nearest t > 0 with |o + t d| = r (rows), standard quadratic."""
  a = (d * d).sum(-1)
  b = 2 * (o * d).sum(-1)
  c = (o * o).sum(-1) - r * r
  disc = b * b - 4 * a * c
  with np.errstate(invalid="ignore"):
    s = np.sqrt(disc)
  ts = np.stack([(-b - s) / (2 * a), (-b + s) / (2 * a)])
  ts = np.where((disc >= 0) & (ts > 0), ts, np.inf)
  return ts.min(0)


def _geom_hits(m, d, env, g, o, dirs):
  """Nearest t of every ray on geom g (float64), inf where it misses."""
  gt = int(m.geom_type[g])
  p = d.geom_xpos[env, g].double().numpy()
  rot = d.geom_xmat[env, g].double().numpy()
  size = m.geom_size[g].double().numpy()
  ol = (o - p) @ rot
  dl = dirs @ rot
  inf = np.full(len(dl), np.inf)
  with np.errstate(divide="ignore", invalid="ignore"):
    if gt == 0:                                          # plane
      t = -ol[2] / dl[:, 2]
      x, y = ol[0] + t * dl[:, 0], ol[1] + t * dl[:, 1]
      return np.where((t > 0) & (np.abs(x) <= size[0])
                      & (np.abs(y) <= size[1]), t, inf)
    if gt == 2:
      return _quadric(np.broadcast_to(ol, dl.shape), dl, size[0])
    if gt == 4:
      return _quadric(np.broadcast_to(ol / size, dl.shape), dl / size, 1.0)
    if gt in (3, 5):                                     # capsule, cylinder
      r, h = size[0], size[1]
      t = _quadric(np.broadcast_to(ol[:2], dl[:, :2].shape), dl[:, :2], r)
      t = np.where(np.abs(ol[2] + t * dl[:, 2]) <= h, t, inf)
      if gt == 3:
        for s in (1, -1):
          c = np.array([0, 0, s * h])
          t = np.minimum(t, _quadric(np.broadcast_to(ol - c, dl.shape), dl,
                                     r))
        return t
      for s in (1, -1):
        tc = (s * h - ol[2]) / dl[:, 2]
        q = ol[:2] + tc[:, None] * dl[:, :2]
        t = np.minimum(t, np.where((tc > 0) & ((q * q).sum(-1) <= r * r),
                                   tc, inf))
      return t
    if gt == 6:                                          # box
      t1 = (-size - ol) / dl
      t2 = (size - ol) / dl
      near = np.minimum(t1, t2).max(-1)
      far = np.maximum(t1, t2).min(-1)
      return np.where((near <= far) & (near > 0), near, inf)
    if gt == 7:
      i = int(m.geom_dataid[g])
      tri = m.mesh_vert[i].astype(np.float64)[m.mesh_face[i]]
      return _tri_hits(np.broadcast_to(ol, dl.shape), dl, tri)
    if gt == 1:                                          # heightfield
      hd = d.hfield_data[env].double().numpy()
      nrow, ncol = hd.shape
      sx, sy = m.hfield_size[:2].double().numpy()
      xs = np.linspace(-sx, sx, ncol)
      ys = np.linspace(-sy, sy, nrow)
      tris = []
      for r in range(nrow - 1):
        for c in range(ncol - 1):
          v = lambda rr, cc: [xs[cc], ys[rr], hd[rr, cc]]
          tris += [[v(r, c), v(r, c + 1), v(r + 1, c + 1)],
                   [v(r, c), v(r + 1, c + 1), v(r + 1, c)]]
      return _tri_hits(np.broadcast_to(ol, dl.shape), dl, np.array(tris))
  raise AssertionError(gt)


def _reference(m, d, env, camera):
  """(depth (H, W), nearest geom (H, W), gap to the second hit (H, W))."""
  o, right, up, fwd, fovy = _camera64(m, d, env, camera)
  tan = np.tan(np.deg2rad(fovy) / 2)
  u = (2 * (np.arange(W) + 0.5) / W - 1) * tan * W / H
  v = (1 - 2 * (np.arange(H) + 0.5) / H) * tan
  dirs = (fwd + u[None, :, None] * right + v[:, None, None] * up)
  dirs = dirs.reshape(-1, 3)
  r = m.render
  znear, zfar = float(r["vis_znear"]), float(r["vis_zfar"])
  shown = [g for g in range(m.ngeom) if int(r["geom_group"][g]) < 3]
  t = np.stack([_geom_hits(m, d, env, g, o, dirs) for g in shown])
  t = np.where((t >= znear) & (t <= zfar), t, np.inf)
  order = np.argsort(t, 0)
  first = np.take_along_axis(t, order[:1], 0)[0]
  second = np.take_along_axis(t, order[1:2], 0)[0]
  gid = np.where(np.isfinite(first), np.array(shown)[order[0]], -1)
  depth = np.where(np.isfinite(first), first, zfar)
  with np.errstate(invalid="ignore"):
    gap = second - first
  return depth.reshape(H, W), gid.reshape(H, W), gap.reshape(H, W)


@pytest.mark.parametrize("camera", [None, "top", "boxcam"],
                         ids=["free", "top", "boxcam"])
def test_scene_against_float64_ray_caster(scene, camera):
  """Every geom class and a heightfield, each env posed by the port: depth
  within 1e-5 relative of the float64 caster on every pixel, segmentation
  ids equal on every pixel whose two nearest hits lie more than 1e-4 m
  apart, (objid, objtype) = (-1, -1) on misses and (id, 5) on hits; the
  hidden group-3 sphere never drawn; every geom class seen."""
  m, d = scene
  r = Renderer(m, W, H)
  depth = r.render(d, camera=camera, depth=True).double().numpy()
  seg = r.render(d, camera=camera, segmentation=True).numpy()
  seen = set()
  for env in range(d.batch):
    ref_depth, ref_id, gap = _reference(m, d, env, camera)
    rel = np.abs(depth[env] - ref_depth) / ref_depth
    print(f"{camera} env {env}: depth {rel.max():.2e} relative, "
          f"{(ref_id >= 0).mean():.3f} of pixels hit")
    assert rel.max() <= 1e-5
    clear = ~(gap <= 1e-4)
    assert np.array_equal(seg[env, ..., 0][clear], ref_id[clear])
    assert np.array_equal(seg[env, ..., 1] == 5, seg[env, ..., 0] >= 0)
    assert np.all(seg[env, ..., 1][seg[env, ..., 0] < 0] == -1)
    seen |= set(seg[env, ..., 0].ravel().tolist())
  assert HIDDEN not in seen
  if camera is None:
    assert {int(m.geom_type[g]) for g in seen if g >= 0} == set(range(8))


def test_rgb_is_lambert_shading_of_geom_rgba(scene):
  """rgb is 0 on misses and geom_rgba times AMBIENT + DIFFUSE |cos| on hits,
  so every hit pixel lies between the ambient and the full colour; the
  batch's rows equal single-env renders bit for bit (rgb, depth,
  segmentation)."""
  m, d = scene
  r = Renderer(m, W, H)
  rgb = r.render(d).numpy().astype(np.float64)
  seg = r.render(d, segmentation=True).numpy()
  hit = seg[..., 0] >= 0
  assert np.all(rgb[~hit] == 0)
  col = m.render["geom_rgba"][seg[..., 0][hit], :3] * 255.0
  assert np.all(rgb[hit] <= col + 0.5 + 1e-9)
  assert np.all(rgb[hit] >= col * 0.3 - 0.5 - 1e-9)
  for env in range(d.batch):
    one = d.replace(**{k: getattr(d, k)[env:env + 1] for k in (
        "qpos", "mocap_pos", "mocap_quat", "hfield_data")})
    for kw in ({}, {"depth": True}, {"segmentation": True}):
      assert torch.equal(r.render(one, camera="boxcam", **kw)[0],
                         r.render(d, camera="boxcam", **kw)[env])


def test_renderer_errors(scene, monkeypatch):
  """An unknown camera raises KeyError naming the cameras; a model whose
  file lacks the render fields raises ValueError naming them;
  PassiveViewer without a display raises RuntimeError naming DISPLAY."""
  m, d = scene
  with pytest.raises(KeyError, match="boxcam"):
    Renderer(m, 8, 8).render(d, camera="nope")
  bare = pio.model_from_numpy({k: v for k, v in pio.model_fields(
      mujoco.MjModel.from_xml_string(SCENE_XML)).items()
      if k not in ("geom_rgba", "cam_fovy")}, "cpu")
  with pytest.raises(ValueError, match="geom_rgba.*cam_fovy"):
    Renderer(bare)
  monkeypatch.delenv("DISPLAY", raising=False)
  monkeypatch.setattr(sys, "platform", "linux")
  with pytest.raises(RuntimeError, match="DISPLAY"):
    PassiveViewer(m)


@pytest.mark.parametrize("name,env_id", [
    ("myohand_reach.npz", "MtxHandReachRandom-v0"),
    ("myoelbow.npz", "MtxElbowPoseRandom-v0")], ids=["hand", "elbow"])
def test_free_camera_fields_match_mujoco(name, env_id):
  """The committed file's free camera is mujoco.mjv_defaultFreeCamera of
  the JAX package's compiled model, bit for bit in float32, and its
  clipping planes vis.map.znear / zfar times stat.extent."""
  mj = myosuite_tpu.make(env_id).mj_model
  cam = mujoco.MjvCamera()
  mujoco.mjv_defaultFreeCamera(mj, cam)
  with np.load(os.path.join(ASSETS, name)) as z:
    np.testing.assert_array_equal(z["free_lookat"],
                                  np.float32(cam.lookat))
    for k in ("distance", "azimuth", "elevation"):
      assert z[f"free_{k}"] == np.float32(getattr(cam, k)), k
    assert z["vis_fovy"] == np.float32(mj.vis.global_.fovy)
    assert z["vis_znear"] == np.float32(mj.vis.map.znear * mj.stat.extent)
    assert z["vis_zfar"] == np.float32(mj.vis.map.zfar * mj.stat.extent)


# ---- C5: batch-invariant products ------------------------------------------

def _helper_cases():
  g = torch.Generator().manual_seed(0)
  r = lambda *s: torch.randn(*s, generator=g)
  mask = (torch.rand(23, 40, generator=g) < 0.3).float() * r(23, 40)
  rows = math.fixed_rows(mask.numpy(), "cpu")
  return {
      "fixed_sum": (lambda x: math.fixed_sum(x, 1),
                    lambda x: x.sum(1), (r(64, 37, 3),)),
      "fixed_mv": (math.fixed_mv, lambda a, v: torch.matmul(
          a, v[..., None])[..., 0], (r(64, 23, 23), r(64, 23))),
      "fixed_vm": (math.fixed_vm, lambda v, a: torch.matmul(
          v[:, None], a)[:, 0], (r(64, 39), r(64, 39, 23))),
      "fixed_mm": (math.fixed_mm, torch.matmul, (r(64, 7, 6),
                                                 r(64, 6, 23))),
      "rows_apply": (lambda x: math.rows_apply(rows, x, 1),
                     lambda x: torch.matmul(mask.to(x.dtype), x),
                     (r(64, 40, 6),)),
  }


@pytest.mark.parametrize("name", list(_helper_cases()))
def test_c5_helper_matches_matmul_and_is_batch_invariant(name):
  """Each helper equals the float32 product it replaces, and the float64
  product, within 1e-6 of the product's scale, and its rows at batch 1
  are bit-equal to its rows at batch 64."""
  ours, ref, args = _helper_cases()[name]
  got = ours(*args)
  for want in (ref(*args).double(), ref(*[a.double() for a in args])):
    gap = float((got.double() - want).abs().max())
    assert gap <= 1e-6 * max(1.0, float(want.abs().max())), gap
  for i in (0, 5, 63):
    one = ours(*[a[i:i + 1] for a in args])
    assert torch.equal(one[0], got[i]), i


def test_hand_step_rows_bit_equal_at_batch_one():
  """A control step of the hand at batch 8 and of its rows alone: every
  field bit-equal (the card's check is chip_smoke.py phase 14a)."""
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device="cpu")
  gen = torch.Generator().manual_seed(5)
  state = env.reset(gen, 8)
  a = torch.rand(8, env.action_size, generator=gen)
  full = env.step(state, a)
  from myosuite_tpu_torch.parallel.mesh import take_rows
  for i in (1, 6):
    one = env.step(take_rows(state, slice(i, i + 1), 8), a[i:i + 1])
    for k in ("qpos", "qvel", "act", "qacc", "ten_J", "qM"):
      assert torch.equal(getattr(one.data, k)[0], getattr(full.data, k)[i])
    assert torch.equal(one.obs["state"][0], full.obs["state"][i])


# ---- visual observations ---------------------------------------------------

@pytest.fixture(scope="module")
def flax_trunk18():
  net = jvisual_nets.ResNetTrunk(stage_sizes=(2, 2, 2, 2))
  params = jax.jit(net.init)(jax.random.PRNGKey(0),
                             jnp.zeros((32, 32, 3), jnp.float32))
  return net, jax.tree_util.tree_map(np.asarray, params)


def test_resnet18_trunk_matches_flax(flax_trunk18):
  """The port's trunk on the flax trunk's parameters (converted HWIO ->
  OIHW) gives the flax features of 3 images at 32 x 32 within 1e-4 of
  their scale; the same parameter count."""
  net, params = flax_trunk18
  img = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                          dtype=np.uint8)
  want = np.stack([np.asarray(net.apply(params, jnp.asarray(
      i, jnp.float32) / 255.0)) for i in img])
  trunk = visual_nets.make_resnet_encoder(
      "resnet18", "cpu", convert.trunk_state_dict_from_flax(params))
  got = trunk(torch.from_numpy(img)).numpy()
  gap = np.abs(got - want).max() / np.abs(want).max()
  print(f"parity gap trunk: {gap:.2e} of the features' scale")
  assert gap <= 1e-4
  assert sum(p.numel() for p in trunk.parameters()) == sum(
      x.size for x in jax.tree_util.tree_leaves(params))


def test_resnet34_parameter_count_matches_flax():
  """ResNet-34's parameters: flax's count (from its shapes, no init run)
  equals the port's; the default trunk is the seed-0 draw on every call."""
  net = jvisual_nets.ResNetTrunk(stage_sizes=(3, 4, 6, 3))
  shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                          jnp.zeros((32, 32, 3), jnp.float32))
  n_flax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
      shapes))
  a = visual_nets.make_resnet_encoder("resnet34", "cpu")
  b = visual_nets.make_resnet_encoder("rrl34", "cpu")
  assert sum(p.numel() for p in a.parameters()) == n_flax
  for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
    assert torch.equal(x, y), k


def test_visual_obs_keys_encoders_and_refusals():
  """The JAX package's key parsing; the encoder table on batches (1d,
  2d, the trunks, with a warning); r3m / vc1 refused; a custom encoder
  taking their place; get_visuals over a batch of the finger."""
  assert visual.parse_visual_key("rgb:view_1:224x224:r3m18") == (
      "rgb", "view_1", (224, 224), "r3m18")
  img = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
  assert visual.make_encoder("1d")(img).shape == (2, 32 * 32 * 3)
  assert visual.make_encoder("2d")(img).shape == (2, 32, 32, 3)
  with pytest.warns(RuntimeWarning, match="NOT ImageNet-pretrained"):
    enc = visual.make_encoder("rrl18", "cpu")
  feat = enc(img)
  assert feat.shape == (2, 512) and torch.isfinite(feat).all()
  gap = float((enc(img[1:]) - feat[1:]).abs().max())
  assert gap <= 1e-5 * float(feat.abs().max())
  env = myosuite_tpu_torch.make("MtxFingerPoseFixed-v0", device="cpu")
  for bad in ("rgb:default:32x32:r3m18", "rgb:default:32x32:vc1s"):
    with pytest.raises(ValueError, match="checkpoint"):
      visual.VisualObs(env, [bad])
  vo = visual.VisualObs(
      env, ["rgb:default:16x16:r3m18", "rgb:default:16x16:1d",
            "d:default:16x16:2d"],
      custom_encoders={"r3m18": lambda x: x.float().mean((1, 2))})
  data = env.reset(torch.Generator().manual_seed(0), 3).data
  out = vo.get_visuals(data)
  assert out["rgb:default:16x16:r3m18"].shape == (3, 3)
  assert out["rgb:default:16x16:1d"].shape == (3, 16 * 16 * 3)
  assert out["d:default:16x16:2d"].shape == (3, 16, 16, 1)
  rgb = Renderer(env, 16, 16).render(data)
  assert torch.equal(out["rgb:default:16x16:1d"], rgb.reshape(3, -1))


# ---- tools -----------------------------------------------------------------

def test_html_matches_jax_byte_for_byte(tmp_path):
  video = tmp_path / "v.mp4"
  video.write_bytes(bytes(range(256)) * 3)
  assert html.video_html(str(video), 320) == jhtml.video_html(str(video),
                                                              320)
  sections = [("a", html.video_html(str(video))), ("b", "<p>x</p>")]
  ours = html.save_report(str(tmp_path / "o" / "r.html"), "T", sections)
  theirs = jhtml.save_report(str(tmp_path / "j" / "r.html"), "T", sections)
  with open(ours, "rb") as f, open(theirs, "rb") as g:
    assert f.read() == g.read()


def test_render_entry_points(tmp_path):
  """GymEnv.render, examine_env --video, examine_logs --mode render,
  render_rollout, render_cams and examine_sim -m --png all write frames
  on the CPU (.gif: imageio's pillow plugin)."""
  import imageio
  gym = gym_adapter.GymEnv("MtxElbowPoseRandom-v0", device="cpu")
  gym.reset(seed=0)
  frame = gym.render()
  assert frame.shape == (480, 640, 3) and frame.dtype == np.uint8

  out = io.StringIO()
  gif = str(tmp_path / "ep.gif")
  with redirect_stdout(out):
    examine_env.main(["-e", "MtxElbowPoseRandom-v0", "-n", "2",
                      "--horizon", "3", "--device", "cpu", "--video", gif])
  assert "saved video" in out.getvalue()
  assert len(imageio.mimread(gif)) == 6

  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  state = env.reset(torch.Generator().manual_seed(0), 2)
  datas = [state.data]
  for _ in range(2):
    state = env.step(state, torch.rand(2, env.action_size))
    datas.append(state.data)
  path = render_rollout(env, datas, str(tmp_path / "roll.gif"))
  frames = imageio.mimread(path)
  assert len(frames) == 3 and frames[0].shape[:2] == (480, 640)
  tr = trace.rollout_to_trace({"qpos": torch.stack([d.qpos[0]
                                                    for d in datas])})
  tpath = str(tmp_path / "t.mtp")
  tr.save(tpath)
  with redirect_stdout(out):
    examine_logs.main(["-t", tpath, "-e", "MtxElbowPoseRandom-v0", "--mode",
                       "render", "--video", str(tmp_path / "logs.gif"),
                       "--device", "cpu"])
  assert len(imageio.mimread(str(tmp_path / "logs.gif"))) == 3
  seq = render_qpos_sequence(env, np.stack([d.qpos[0].numpy()
                                            for d in datas]),
                             str(tmp_path / "seq.gif"))
  assert np.array_equal(np.stack(imageio.mimread(seq)), np.stack(frames))

  cams = render_cams.render_all_cams(env, width=40, height=30)
  assert list(cams) == ["free"] and cams["free"].shape == (30, 40, 3)
  with redirect_stdout(out):
    render_cams.main(["-e", "MtxElbowPoseRandom-v0", "-o",
                      str(tmp_path / "cams"), "--device", "cpu"])
  assert os.path.exists(tmp_path / "cams" / "free.png")

  xml = tmp_path / "scene.xml"
  xml.write_text(SCENE_XML)
  with redirect_stdout(out):
    examine_sim.main(["-m", str(xml), "-n", "2", "--device", "cpu",
                      "--png", str(tmp_path / "snap")])
    examine_sim.main(["-e", "MtxElbowPoseRandom-v0", "-n", "2",
                      "--device", "cpu"])
  assert imageio.v2.imread(str(tmp_path / "snap.png")).shape == (480, 640,
                                                                  3)
  assert "finite=True" in out.getvalue()

"""The port's contacts against the JAX package and MuJoCo.

Every collision class of `myosuite_tpu_torch.physics.collision` is held
against its JAX function on the same numpy-seeded geom poses and sizes,
degenerate cases included (coincident sphere centres, parallel capsules,
axis-aligned boxes with tied corners, points on triangle edges and
vertices); the heightfield classes on supplied height grids; the mesh
classes on the die mesh of tests/test_mesh_contacts.py. `make_efc`'s
contact rows, the per-contact force sum and multi-substep trajectories are
held against the JAX package on three contact models at supplied states,
and trajectories against MuJoCo at the tolerances of
tests/test_step_parity.py.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from myosuite_tpu.physics import collision as jcol
from myosuite_tpu.physics import constraint as jcon
from myosuite_tpu.physics import forward as jfwd
from myosuite_tpu.physics import io as jio
from myosuite_tpu.physics.types import GeomType
from myosuite_tpu_torch.physics import collision as tcol
from myosuite_tpu_torch.physics import constraint as tcon
from myosuite_tpu_torch.physics import forward as tfwd
from myosuite_tpu_torch.physics import io as tio
from tests.common import CHAIN_XML, randomize_state
from tests.test_mesh_contacts import DIE_MESH_XML
from tests.test_step_parity import FALLING_XML
from tests.test_torch_step import TRAJ_ATOL, _rollout_vs_mujoco
from tests.torch_common import MUSCLE_XML6, assert_close, solver_6x6

# Geometry in float32 from two implementations that order their sums
# differently: positions of ~1 m agree to a few 1e-7 m.
GEOM_ATOL = 1e-5

CHAIN6_XML = CHAIN_XML.replace(
    '<option timestep="0.002" gravity="0 0 -9.81"/>',
    '<option timestep="0.002" gravity="0 0 -9.81" iterations="6" '
    'ls_iterations="6"/>')
FALLING6_XML = solver_6x6(FALLING_XML)


def _random_quat(rng, n):
  q = rng.standard_normal((n, 4))
  return q / np.linalg.norm(q, axis=1, keepdims=True)


def _mat(q):
  out = np.zeros((len(q), 9))
  for i, qi in enumerate(q):
    mujoco.mju_quat2Mat(out[i], qi)
  return out.reshape(-1, 3, 3)


def _poses(rng, n, spread=0.25):
  """n random geom poses (p, mat) and sizes (radius, half length, ...)."""
  p = rng.uniform(-spread, spread, (n, 3))
  m = _mat(_random_quat(rng, n))
  s = np.stack([rng.uniform(0.04, 0.2, n), rng.uniform(0.05, 0.3, n),
                rng.uniform(0.04, 0.2, n)], 1)
  return p, m, s


def _degenerate(key):
  """Hand-made poses where a clamp or a tie-break decides the result."""
  eye = np.eye(3)
  s = np.array([0.1, 0.2, 0.15])
  cases = [
      # coincident centres / geoms: a zero normal into _make_frame
      (np.zeros(3), eye, s, np.zeros(3), eye, s),
      # axis-aligned, equal orientations: tied corner depths, parallel
      # capsule axes (the capsule-capsule denominator clamp)
      (np.zeros(3), eye, s, np.array([0.05, 0.0, 0.25]), eye, s),
      (np.zeros(3), eye, s, np.array([0.0, 0.3, 0.0]), eye, s),
  ]
  if key[0] == GeomType.PLANE:
    # a plane at the origin (its normal +z), the geom just touching it
    cases.append((np.zeros(3), eye, np.array([1.0, 1.0, 0.1]),
                  np.array([0.1, -0.2, 0.14]), eye, s))
  return [np.stack(c) for c in zip(*cases)]


def _class_inputs(key, seed, n=24):
  """n random pairs in the contact regime: geom 2's centre at the sum of
  the two radii (size[0]) from geom 1's, -3 cm to +5 cm, in a random
  direction; then the degenerate cases."""
  rng = np.random.default_rng(seed)
  p1, m1, s1 = _poses(rng, n)
  _, m2, s2 = _poses(rng, n)
  u = rng.standard_normal((n, 3))
  u /= np.linalg.norm(u, axis=1, keepdims=True)
  p2 = p1 + u * (s1[:, :1] + s2[:, :1] + rng.uniform(-0.03, 0.05, (n, 1)))
  if key[0] == GeomType.PLANE:
    # planes tilted up to ~0.2 rad from +z, geom 2 above or just in them
    q = np.concatenate([np.ones((n, 1)), rng.uniform(-0.1, 0.1, (n, 3))], 1)
    m1 = _mat(q / np.linalg.norm(q, axis=1, keepdims=True))
    p2 = p1 + m1[:, :, 2] * (s2[:, :1] + rng.uniform(-0.03, 0.1, (n, 1)))
    p2 += rng.uniform(-0.3, 0.3, (n, 3)) * [1, 1, 0]
  deg = _degenerate(key)
  return [np.concatenate([a, b]).astype(np.float32)
          for a, b in zip((p1, m1, s1, p2, m2, s2), deg)]


def _frames64(jfn, args):
  """The JAX fn run in float64 on the same inputs: the length of each
  normal and the contact frames, a reference that neither float32 frame
  takes part in."""
  with jax.enable_x64(True):
    n = jax.jit(jax.vmap(jfn))(*[jnp.asarray(a, jnp.float64) for a in args])[2]
    assert n.dtype == jnp.float64
    return (np.linalg.norm(np.asarray(n), axis=-1),
            np.asarray(jax.vmap(jax.vmap(jcol._make_frame))(n)))


def _compare_class(name, tfn, jfn, args, n_random, atol=GEOM_ATOL):
  """Port fn on (B=1, n) tensors against the JAX fn vmapped over n: dist
  and pos within atol, and the contact frame within atol of the JAX frame.

  Where a frame entry is not, both float32 frames are held against the
  JAX fn run in float64. A normal computed as (closest - centre) /
  |closest - centre| with that distance near zero (a box corner 0.3 mm
  inside a face) is conditioned by 1 / distance in float32 in both
  packages, so both frames carry rounding errors of ~1e-5 of their own:
  the port's entry must then lie within atol of the float64 frame, or
  within twice the JAX float32 entry's own distance from it. Rows past
  `n_random` are the hand-made degenerate cases. Only there may the
  float64 normal be shorter than 1e-6: the geoms touch at the query point,
  the normal's direction is rounding noise in every precision, and the
  port's frame must be all zero or orthonormal."""
  jd, jp, jn = jax.jit(jax.vmap(jfn))(*map(jnp.asarray, args))
  jf = np.asarray(jax.vmap(jax.vmap(jcol._make_frame))(jn), np.float64)
  td, tp, tn = tfn(*[torch.from_numpy(a)[None] for a in args])
  assert_close(f"{name} dist", td[0], jd, atol=atol)
  assert_close(f"{name} pos", tp[0], jp, atol=atol)
  tf = tcol._make_frame(tn)[0].double().numpy()
  gap = np.abs(tf - jf)
  far = gap > atol
  print(f"parity gap {name} frame: {gap.max():.3e} (atol {atol:g}; "
        f"{int(far.sum())} entries beyond it)")
  if not far.any():
    return
  norm64, f64 = _frames64(jfn, args)
  undefined = norm64 < 1e-6
  assert not undefined[:n_random].any(), f"{name}: no normal at a random pose"
  err64, jerr64 = np.abs(tf - f64), np.abs(jf - f64)
  near64 = err64 <= np.maximum(atol, 2 * jerr64)
  eye = np.einsum("...ij,...kj->...ik", tf, tf)
  valid = (np.abs(tf).max((-2, -1)) == 0) | (
      np.abs(eye - np.eye(3)).max((-2, -1)) <= atol)
  ok = ~far | near64 | (undefined & valid)[..., None, None]
  print(f"  against float64: port {err64[far].max():.3e}, JAX float32 "
        f"{jerr64[far].max():.3e}; {int((far & ~near64).sum())} entries "
        f"beyond, in {int(undefined.sum())} degenerate contacts with no "
        f"float64 normal")
  assert ok.all(), f"{name} frame"


@pytest.mark.parametrize("key", list(jcol._FNS),
                         ids=lambda k: f"{k[0].name}-{k[1].name}")
def test_primitive_class_matches_jax(key):
  args = _class_inputs(key, seed=int(key[0]) * 8 + int(key[1]))
  _compare_class(f"{key[0].name}-{key[1].name}", tcol._FNS[key],
                 jcol._FNS[key], args, n_random=24)


def test_make_frame_degenerate_normals():
  n = np.array([[0, 0, 0], [1e-12, 0, 0], [0.3, 0, 0], [0.5, 0.5, 0],
                [0.0, 0.0, -2.0], [0.49999, 0.8, 0.1]], dtype=np.float32)
  assert_close("frame", tcol._make_frame(torch.from_numpy(n)),
               jax.vmap(jcol._make_frame)(jnp.asarray(n)), atol=GEOM_ATOL)


def _hfield_data(seed, nrow=12, ncol=16):
  rng = np.random.default_rng(seed)
  x = np.linspace(0, 2 * np.pi, ncol)
  base = 0.05 * np.sin(x)[None, :] + 0.02 * np.cos(np.arange(nrow))[:, None]
  return (base + rng.uniform(0, 0.01, (nrow, ncol))).astype(np.float32)


@pytest.mark.parametrize("key", list(jcol._HF_FNS),
                         ids=lambda k: f"HFIELD-{k[1].name}")
def test_hfield_class_matches_jax(key):
  """Two envs, each with its own supplied height grid, 12 geoms each."""
  size = np.array([1.0, 0.8, 1.0, 0.1], dtype=np.float32)
  rng = np.random.default_rng(int(key[1]))
  B, n = 2, 12
  hdata = np.stack([_hfield_data(b) for b in range(B)])
  p1 = np.tile(np.array([0.1, -0.05, 0.0], dtype=np.float32), (B, n, 1))
  m1 = np.tile(np.eye(3, dtype=np.float32), (B, n, 1, 1))
  s1 = np.zeros((B, n, 3), dtype=np.float32)
  p2, m2, s2 = _poses(rng, B * n, spread=0.9)
  p2[:, 2] = rng.uniform(0.0, 0.25, B * n)
  p2[0] = [5.0, -3.0, 0.1]               # off the grid: clamped lookups
  shaped = lambda x: x.reshape((B, n) + x.shape[1:]).astype(np.float32)
  p2, m2, s2 = shaped(p2), shaped(m2), shaped(s2)
  td, tp, tn = tcol._HF_FNS[key](torch.from_numpy(hdata),
                                 torch.from_numpy(size))(
      *[torch.from_numpy(a) for a in (p1, m1, s1, p2, m2, s2)])
  jrun = jax.jit(lambda h, *a: jax.vmap(jcol._HF_FNS[key](h, jnp.asarray(
      size)))(*a))
  for b in range(B):
    jd, jp, jn = jrun(jnp.asarray(hdata[b]),
                      *[jnp.asarray(a[b]) for a in (p1, m1, s1, p2, m2, s2)])
    assert_close(f"hfield {key[1].name} env {b} dist", td[b], jd,
                 atol=GEOM_ATOL)
    assert_close(f"hfield {key[1].name} env {b} pos", tp[b], jp,
                 atol=GEOM_ATOL)
    assert_close(f"hfield {key[1].name} env {b} frame",
                 tcol._make_frame(tn[b]),
                 jax.vmap(jax.vmap(jcol._make_frame))(jn), atol=GEOM_ATOL)


def _die_tables():
  mj = mujoco.MjModel.from_xml_string(DIE_MESH_XML)
  fields = tio.model_fields(mj)
  return fields["mesh_vert_0"], fields["mesh_face_0"]


@pytest.mark.parametrize("t1", [GeomType.PLANE, GeomType.SPHERE,
                                GeomType.CAPSULE, GeomType.BOX],
                         ids=lambda t: f"{t.name}-MESH")
def test_mesh_class_matches_jax(t1):
  verts, faces = _die_tables()
  key = (t1, GeomType.MESH)
  tfn = tcol._mesh_fns(tcol.mesh_tables(verts, faces, "cpu"))[key]
  jfn = jcol._mesh_factory(verts, faces)[key]
  args = _class_inputs(key, seed=int(t1), n=16)
  # dice near the other geom; the last one axis-aligned with a corner on
  # the other geom's centre
  args[3] = (args[3] * 0.3).astype(np.float32)
  args[3][-1] = args[0][-1] + np.float32(0.023)
  args[4][-1] = np.eye(3, dtype=np.float32)
  _compare_class(f"{t1.name}-MESH", tfn, jfn, args, n_random=16)


def test_closest_on_tri_edges_and_vertices():
  """Points in every Voronoi region of a triangle, on its edges and at its
  vertices, and a zero-area triangle."""
  a, b, c = (np.array(v, dtype=np.float32) for v in
             ([0, 0, 0], [1, 0, 0], [0, 1, 0]))
  pts = np.array([[0.2, 0.2, 0.5], [-1, -1, 0], [2, -0.5, 0], [-0.5, 2, 0],
                  [0.5, -1, 0.1], [-1, 0.5, 0], [1, 1, 0], [0.5, 0.5, 0],
                  [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0]],
                 dtype=np.float32)
  tri = [np.tile(v, (len(pts), 1)) for v in (a, b, c)]
  flat = [np.tile(v, (len(pts), 1)) for v in (a, a, b)]   # zero area
  for name, (ta, tb, tc) in (("triangle", tri), ("zero-area", flat)):
    got = tcol._closest_on_tri(*[torch.from_numpy(x)
                                 for x in (pts, ta, tb, tc)])
    want = jax.vmap(jcol._closest_on_tri)(*map(jnp.asarray,
                                                (pts, ta, tb, tc)))
    assert_close(f"closest_on_tri {name}", got, want, atol=GEOM_ATOL)


# ---------------------------------------------------------------------------
# constraint rows, contact forces and trajectories of whole models
# ---------------------------------------------------------------------------


def _states(xml, seeds, lift=None):
  """(B, nq), (B, nv) float32 states from tests.common.randomize_state;
  `lift` sets each free body's height per env to bring contacts in."""
  mj = mujoco.MjModel.from_xml_string(xml)
  qs, vs = [], []
  for i, s in enumerate(seeds):
    d = randomize_state(mj, seed=s)
    if lift is not None:
      for j in range(mj.njnt):
        if mj.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE:
          d.qpos[mj.jnt_qposadr[j] + 2] = lift[i]
    qs.append(d.qpos.copy())
    vs.append(d.qvel.copy())
  return (np.stack(qs).astype(np.float32), np.stack(vs).astype(np.float32))


_MODELS = {
    # the full muscle arm: its two capsules meet at the elbow
    "muscle": (MUSCLE_XML6, None),
    # a floor under three capsules and a free sphere: plane-capsule,
    # plane-sphere, capsule-capsule and sphere-capsule, 8 pairs
    "chain": (CHAIN6_XML, [0.04, 0.2, 0.06]),
    "falling": (FALLING6_XML, [0.02, 0.3, 0.045]),
}


def _stack(trees):
  """One pytree of per-env pytrees, each leaf stacked on a leading env
  axis."""
  return jax.tree.map(lambda *x: jnp.stack(x), *trees)


def _both_at_state(xml, qpos, qvel):
  """(JAX Data after fwd_position + fwd_velocity, JAX make_efc's first
  five outputs on it, port Data after the same, JAX model, port model) at
  the supplied states. The JAX side is one compile of one env, run env by
  env (the vmapped compile takes up to twice as long on a CPU)."""
  mj = mujoco.MjModel.from_xml_string(xml)
  jm, tm = jio.put_model(mj), tio.put_model(mj, "cpu")

  @jax.jit
  def settle(q, v):
    d = jio.make_data(jm).replace(qpos=q, qvel=v)
    d = jfwd.fwd_velocity(jm, jfwd.fwd_position(jm, d))
    return d, jcon.make_efc(jm, d)[:5]

  jd, jefc = _stack([settle(jnp.asarray(q), jnp.asarray(v))
                     for q, v in zip(qpos, qvel)])
  td = tio.make_data(tm, qpos.shape[0], "cpu").replace(
      qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel))
  td = tfwd.fwd_velocity(tm, tfwd.fwd_position(tm, td))
  return jd, jefc, td, jm, tm


@pytest.mark.parametrize("name", list(_MODELS))
def test_make_efc_contact_rows_match_jax(name):
  """J, aref, R and active of every row (contact rows last, in the JAX
  row order) at supplied states, and the contact set under them."""
  xml, lift = _MODELS[name]
  qpos, qvel = _states(xml, (1, 2, 3), lift)
  jd, jefc, td, jm, tm = _both_at_state(xml, qpos, qvel)
  assert tm.ncon_max == jm.ncon_max > 0
  if name == "chain":
    assert len(tm.collision_pairs) == 8
  for f in ("dist", "pos", "frame", "includemargin", "friction", "solref",
            "solimp"):
    assert_close(f"{name} contact.{f}", getattr(td.contact, f),
                 getattr(jd.contact, f), atol=GEOM_ATOL)
  np.testing.assert_array_equal(td.ncon_active.numpy(), jd.ncon_active)
  assert int(td.ncon_active.sum()) > 0, "no active contact at the states"
  for f in ("geom1", "geom2", "dim"):
    np.testing.assert_array_equal(getattr(td.contact, f).numpy(),
                                  getattr(jd.contact, f).arr)

  tefc = tcon.make_efc(tm, td)
  plan = tm.plan["constraint"]
  assert plan.nefc == jefc[0].shape[1]
  np.testing.assert_array_equal(plan.con_slots.numpy(),
                                jcon._efc_plan(jm).con_slots)
  for f, ours, ref in zip(("J", "aref", "R"), tefc[:3], jefc[:3]):
    assert_close(f"{name} efc {f}", ours, ref, atol=GEOM_ATOL, rtol=1e-5)
  np.testing.assert_array_equal(tefc.active.numpy(), np.asarray(jefc[4]))


@pytest.mark.parametrize("name", list(_MODELS))
def test_contact_force_matches_jax_segment_sum(name):
  """The port's per-slot sum of the pyramidal row forces against the JAX
  package's segment_sum over its own row -> slot map, on the port's
  constraint forces after one step."""
  xml, lift = _MODELS[name]
  qpos, qvel = _states(xml, (4, 5), lift)
  mj = mujoco.MjModel.from_xml_string(xml)
  jm, tm = jio.put_model(mj), tio.put_model(mj, "cpu")
  td = tio.make_data(tm, 2, "cpu").replace(qpos=torch.from_numpy(qpos),
                                           qvel=torch.from_numpy(qvel))
  td = tfwd.forward(tm, td)
  slots = jcon._efc_plan(jm).con_slots
  rows = np.nonzero(slots >= 0)[0]
  force = jnp.asarray(td.efc_force.numpy())
  want = jax.vmap(lambda f: jax.ops.segment_sum(
      f[rows], jnp.asarray(slots[rows]), num_segments=jm.ncon_max))(force)
  assert_close(f"{name} contact_force", td.contact_force, want, atol=1e-5,
               rtol=1e-6)
  assert float(td.contact_force.abs().max()) > 0


@pytest.mark.parametrize("name", list(_MODELS))
def test_step_n_matches_jax(name):
  """3 segments of 5 substeps at supplied states and controls; qpos, qvel
  and act within TRAJ_ATOL of the JAX package after each segment, as
  tests/test_torch_step.py::_rollout_both holds them. The JAX step_n is
  one compile of one env, run env by env (the vmapped compile takes up to
  twice as long on a CPU)."""
  xml, lift = _MODELS[name]
  qpos, qvel = _states(xml, (6, 7, 8), lift)
  mj = mujoco.MjModel.from_xml_string(xml)
  jm, tm = jio.put_model(mj), tio.put_model(mj, "cpu")
  run = jax.jit(lambda d: jfwd.step_n(jm, d, 5))
  jds = [jio.make_data(jm).replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v))
         for q, v in zip(qpos, qvel)]
  td = tio.make_data(tm, 3, "cpu").replace(qpos=torch.from_numpy(qpos),
                                           qvel=torch.from_numpy(qvel))
  rng = np.random.default_rng(9)
  for _ in range(3):
    ctrl = rng.uniform(0, 1, (3, mj.nu)).astype(np.float32)
    jds = [run(d.replace(ctrl=jnp.asarray(c))) for d, c in zip(jds, ctrl)]
    td = tfwd.step_n(tm, td.replace(ctrl=torch.from_numpy(ctrl)), 5)
    jd = _stack(jds)
    for f in ("qpos", "qvel", "act"):
      assert_close(f"{name} {f}", getattr(td, f), getattr(jd, f),
                   atol=TRAJ_ATOL)


def test_muscle_arm_with_elbow_contact_vs_mujoco():
  """The full muscle arm (its elbow contact included) under sinusoidal
  excitation; tolerances of tests/test_step_parity.py."""
  ctrl = lambda i: np.array([0.5 + 0.5 * np.sin(0.02 * i), 0.3])
  ours, ref, d, mjd = _rollout_vs_mujoco(MUSCLE_XML6, 300, ctrl)
  np.testing.assert_allclose(ours[-1], ref[-1], atol=5e-3)
  np.testing.assert_allclose(d.act[0].numpy(), mjd.act, atol=5e-3)


def test_contact_settle_vs_mujoco():
  """Ball and capsule fall onto the plane and settle (0.6 s); tolerances
  of tests/test_step_parity.py::test_contact_settle (which runs 1 s)."""
  ours, ref, _, _ = _rollout_vs_mujoco(FALLING6_XML, 300)
  np.testing.assert_allclose(ours[-1][2], ref[-1][2], atol=1e-3)
  np.testing.assert_allclose(ours[-1][9], ref[-1][9], atol=1e-3)
  np.testing.assert_allclose(ours[-1][:3], ref[-1][:3], atol=5e-3)
  np.testing.assert_allclose(ours[-1][7:10], ref[-1][7:10], atol=5e-3)

"""The Newton solve's wide route against the JAX package.

Past nv 40, or past the warp kernel's shared memory, the port's Newton
solve takes its wide route (`newton_kernel.route`): on the card the
block-per-env kernel `csrc/newton_solver_wide.cu`, on the CPU its plain
version `newton_solve_wide_reference`. Here that plain version is held
against vmap of the JAX package's `newton_xla` (+ `linalg.solve_pd` for
a_smooth) and against the Pallas kernel in interpret mode, on the
synthetic systems of tests/test_pallas_parity.py, at the JAX tests'
tolerance (rtol = atol = 1e-4); the route of every committed model file is
pinned; and the Relocate scene with two more loose spheres (nv 45, nefc
375), stepped through `make(..., overrides={"model_xml": ...})`, replays
the JAX package's trajectory (myosuite_tpu_torch/assets/wide_golden.npz).
The kernel itself is held to its plain version on the card by
tests/test_torch_kernel_cuda.py and `chip_smoke.py` phase 16. Regenerate
the golden and the scene's compiled copy with

  JAX_PLATFORMS=cpu python -m tests.test_torch_wide_solver

(the JAX side runs op by op in a process of its own, ~20 min: the XLA
compile of the arm's batched step does not finish in half an hour).
"""

import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
from myosuite_tpu.assets import builder as jax_builder
from myosuite_tpu.assets import hand as jax_hand
from myosuite_tpu.physics import linalg as jax_linalg
from myosuite_tpu.physics import pallas_solver
from myosuite_tpu.physics import solver as jax_solver
from myosuite_tpu.physics.constraint import Efc as JaxEfc
from myosuite_tpu_torch.envs import registry
from myosuite_tpu_torch.physics import newton_kernel as nk
from tests.test_pallas_parity import _random_system
from tests.torch_common import assert_close

NAMES = ("qacc", "qfrc", "force", "a_smooth", "qacc_euler")


@pytest.fixture(autouse=True)
def one_thread():
  """The plain version is a chain of small ops, which threads only slow
  down when other processes share the cores (a test run's workers)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)

# Two loose spheres of the Relocate object's size, mass, contype and
# conaffinity, one on either side of it, 2 mm clear of it: nv 45 (the
# arm's 27 dofs and three free bodies), nefc 375.
CLUTTER = """
    <body name="clutter_0" pos="-0.082 0.02 1.0">
      <freejoint name="clutter_0_free"/>
      <geom name="clutter_0_geom" type="sphere" size="0.04" mass="0.2"
            contype="2" conaffinity="7"/>
    </body>
    <body name="clutter_1" pos="0.082 0.02 1.0">
      <freejoint name="clutter_1_free"/>
      <geom name="clutter_1_geom" type="sphere" size="0.04" mass="0.2"
            contype="2" conaffinity="7"/>
    </body>
"""
SCENE_SHAPE = (45, 375)   # (nv, nefc)

GOLDEN = os.path.join(registry.ASSETS, "wide_golden.npz")
GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")
GOLDEN_BATCH, GOLDEN_STEPS = 2, 3
INFO_KEYS = ("obj_scale", "obj_mass_scale", "obj_friction_scale",
             "goal_pos")


def scene_xml():
  """The cluttered Relocate scene's MJCF, from the port's builders."""
  from myosuite_tpu_torch.mjcf import builder, hand
  return builder.finalize_muscles(hand.build_hand(
      arm=True, obj="relocate", extra_worldbody=CLUTTER))


def jax_scene_xml():
  """The same scene from the JAX package's builders."""
  return jax_builder.finalize_muscles(jax_hand.build_hand(
      arm=True, obj="relocate", extra_worldbody=CLUTTER))


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------


def golden_actions(width):
  rng = np.random.default_rng(2045)
  return rng.uniform(0, 1, (GOLDEN_STEPS, GOLDEN_BATCH, width)).astype(
      np.float32)


def jax_golden():
  """The scene in the JAX package, op by op: batch 2, 3 control steps of
  numpy actions; the reset (qpos, qvel, task info), and obs, reward, done,
  qpos, qvel and act after each step."""
  env = myosuite_tpu.make("MtxRelocate-v0", {"model_xml": jax_scene_xml()})
  out = {}
  with jax.disable_jit():
    keys = jax.random.split(jax.random.PRNGKey(0), GOLDEN_BATCH)
    state = jax.vmap(env.reset)(keys)
    out["init_qpos"] = np.asarray(state.data.qpos)
    out["init_qvel"] = np.asarray(state.data.qvel)
    out.update({"init_info_" + k: np.asarray(state.info[k])
                for k in INFO_KEYS})
    out["actions"] = golden_actions(env.action_size)
    rec = {k: [] for k in GOLDEN_FIELDS}
    for a in out["actions"]:
      state = jax.vmap(env.step)(state, jnp.asarray(a))
      for k, v in zip(GOLDEN_FIELDS, (state.obs["state"], state.reward,
                                      state.done, state.data.qpos,
                                      state.data.qvel, state.data.act)):
        rec[k].append(np.asarray(v))
  out.update({k: np.stack(v) for k, v in rec.items()})
  return out


def port_replay(golden, device):
  """The golden's reset and actions through the port's cluttered Relocate
  on `device`; returns the fields (numpy)."""
  from myosuite_tpu_torch.envs.challenge import state_from
  env = registry.make("MtxRelocate-v0", device=device,
                      overrides={"model_xml": scene_xml()})
  dev = torch.device(device)
  state = env.reset(torch.Generator(dev).manual_seed(0), GOLDEN_BATCH)
  at = lambda k: torch.from_numpy(golden[k]).to(dev)
  info = {k: at("init_info_" + k) for k in INFO_KEYS}
  state = state_from(env, state, at("init_qpos"), at("init_qvel"), info)
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in golden["actions"]:
    state = env.step(state, torch.from_numpy(a).to(dev))
    for k, v in zip(GOLDEN_FIELDS, (state.obs["state"], state.reward,
                                    state.done, state.data.qpos,
                                    state.data.qvel, state.data.act)):
      rec[k].append(v.cpu().numpy())
  return {k: np.stack(v) for k, v in rec.items()}


def _jax_golden_in_process():
  """jax_golden in a process of its own (its memory goes with it)."""
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "wide.npz")
    subprocess.run([sys.executable, "-m", "tests.test_torch_wide_solver",
                    "--jax-golden", path], check=True)
    with np.load(path) as z:
      return {k: z[k] for k in z.files}


def write_golden(golden=None):
  """Write the scene's compiled copy (`export.write_compiled`, for the
  card, which has no MuJoCo) and the golden file: the scene's MJCF (the
  card cannot sweep its muscles), the JAX trajectory (run afresh unless
  given) plus, per field, the tolerance the port is held to: 10x the
  largest gap between the port (CPU) and the JAX package, and at least
  1e-4 of max(1, the field's scale)."""
  from myosuite_tpu_torch.mjcf import export
  print("wrote", export.write_compiled(scene_xml(), "myoarm_relocate.npz"))
  golden = golden or _jax_golden_in_process()
  ours = port_replay(golden, "cpu")
  tols = {}
  for k in GOLDEN_FIELDS:
    gap = float(np.abs(ours[k] - golden[k]).max())
    scale = float(np.abs(golden[k]).max())
    tols["atol_" + k] = np.float64(max(10 * gap, 1e-4 * max(scale, 1.0)))
    print(f"{k}: max gap {gap:.3e}, scale {scale:.3e}, tolerance "
          f"{float(tols['atol_' + k]):.3e}")
  np.savez_compressed(GOLDEN, **golden, **tols,
                      scene_xml=np.asarray(scene_xml()))
  print("wrote", GOLDEN)


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------


def _systems(seed, batch, nv, nefc, n_fr):
  rng = np.random.default_rng(seed)
  return [np.stack(x) for x in zip(
      *[_random_system(rng, nv, nefc, n_fr) for _ in range(batch)])]


@pytest.mark.parametrize("nv,nefc,n_fr", [
    (48, 60, 3), (38, 1200, 0),
    pytest.param(41, 9, 0, marks=pytest.mark.slow),
    pytest.param(96, 150, 3, marks=pytest.mark.slow),
    pytest.param(256, 300, 0, marks=pytest.mark.slow)])
def test_wide_plain_matches_xla(nv, nefc, n_fr):
  """`newton_solve` on the CPU at wide shapes (nv 48; and 1,200 rows at nv
  38, past the warp kernel's shared memory; slow: nv 41, 96 and 256, whose
  unrolled XLA solve takes minutes to compile) against vmap of newton_xla
  and linalg.solve_pd. Two Newton iterations of two line-search steps
  bound the XLA compile; the card holds the kernel's 6 x 6 to this plain
  version."""
  assert nk.route(nv, nefc) == "wide"
  args = _systems(11 + nv, 3, nv, nefc, n_fr)
  if n_fr == 0:     # some rows push at the solution
    args[2][:, :] = np.abs(args[2]) + 0.5
  before = (nk.launches, nk.launches_wide)
  ours = nk.newton_solve(*map(torch.from_numpy, args), n_friction=n_fr,
                         iterations=2, ls_iterations=2)
  assert (nk.launches, nk.launches_wide) == before
  is_friction = np.arange(nefc) < n_fr

  def one(qM, J, aref, R, floss, active, warm, qfrc_smooth, damph):
    a_smooth = jax_linalg.solve_pd(qM, qfrc_smooth)
    efc = JaxEfc(J=J, aref=aref, R=R, floss=floss, active=active != 0,
                 is_friction=is_friction)
    qacc, qfrc, force = jax_solver.newton_xla(qM, efc, warm, a_smooth, 2, 2)
    qacc_euler = jax_linalg.solve_pd(qM + jnp.diag(damph),
                                     qfrc_smooth + qfrc)
    return qacc, qfrc, force, a_smooth, qacc_euler

  xla = jax.jit(jax.vmap(one))(*map(jnp.asarray, args))
  assert (ours[2][:, n_fr:] != 0).any(), "no limit row pushes"
  for o, x, name in zip(ours, xla, NAMES):
    np.testing.assert_allclose(o.numpy(), x, rtol=1e-4, atol=1e-4,
                               err_msg=name)


@pytest.mark.slow
def test_wide_plain_matches_pallas():
  """nv 44 against the Pallas kernel in interpret mode (nv 35 took ~70 s
  per shape on a CPU, hence slow)."""
  nv, nefc, n_fr = 44, 40, 3
  args = _systems(12, 4, nv, nefc, n_fr)
  ours = nk.newton_solve(*map(torch.from_numpy, args), n_friction=n_fr,
                         iterations=6, ls_iterations=6)
  pallas = pallas_solver.solve_batched(
      *map(jnp.asarray, args),
      is_friction=tuple([True] * n_fr + [False] * (nefc - n_fr)),
      iterations=6, ls_iterations=6, interpret=True)
  for o, p, name in zip(ours, pallas, NAMES):
    np.testing.assert_allclose(o.numpy(), p, rtol=1e-4, atol=1e-4,
                               err_msg="pallas " + name)


@pytest.mark.parametrize("case", nk.WIDE_EDGE_CASES,
                         ids=lambda c: "nv{}-nefc{}-fr{}-{}-b{}{}".format(
                             *c[:5], "-nonpd" if c[5] else ""))
def test_wide_edge_rows_solve_their_systems(case):
  """The plain version on the wide EDGE_CASES rows, which the card holds
  the wide kernel to bit for bit: every row takes the wide route, two of
  them with a working set past shared memory (the kernel's device-memory
  workspace), and the outputs solve their systems."""
  from tests.test_torch_solver import check_solves_its_systems
  assert nk.route(*case[:2]) == "wide"
  if case[:2] in ((200, 100), (256, 300)):
    assert nk.wide_smem_bytes(*case[:2]) > nk._SMEM_LIMIT
  seed = 100 + nk.WIDE_EDGE_CASES.index(case)
  check_solves_its_systems(case, nk.random_batch(seed, *case))


@pytest.mark.parametrize("case", nk.WIDE_FINISH_CASES,
                         ids=lambda c: "nv{}-nefc{}-fr{}".format(*c[:3]))
def test_wide_finish_rows_solve_their_systems(case):
  """The plain version on the rows around the wide kernel's warp finish,
  which the card holds the wide kernel to bit for bit by calling it
  directly: they take the warp route, and the outputs solve their
  systems."""
  from tests.test_torch_solver import check_solves_its_systems
  assert nk.route(*case[:2]) == "warp"
  seed = 200 + nk.WIDE_FINISH_CASES.index(case)
  check_solves_its_systems(case, nk.random_batch(seed, *case))


@pytest.mark.parametrize("nv, nefc, floats", [
    (45, 375, 4 + 45 * 45 + 1035 + 7 * 45 + 7 * 375),
    (38, 336, 4 + 38 * 39 + 741 + 7 * 38 + 7 * 336),
    (64, 90, 4 + 64 * 65 + 2080 + 7 * 64 + 7 * 90 + 2 * 64 + 6)])
def test_wide_smem_bytes_is_the_kernels_layout(nv, nefc, floats):
  """wide_smem_bytes is the wide kernel's shared-memory layout: 4
  scalars, qM at an odd row stride, the packed triangle, 7 dof and 7 row
  vectors, the factor's pair buffer (2 nv floats, 5 scalars, one to align
  it) inside the row vector of J p where that holds it (the scene,
  Bimanual), else after the rows (nv 64 at 90 rows); at the scene 8 envs
  fit the 196 KB shared-memory split (200,704 bytes) that the kernel's
  launch asks for, with the 1,024 each block reserves."""
  assert nk.wide_smem_bytes(nv, nefc) == 4 * floats
  if (nv, nefc) == (45, 375):
    assert 8 * (nk.wide_smem_bytes(nv, nefc) + 1024) <= 196 * 1024


# ---------------------------------------------------------------------------
# routes and the cluttered scene
# ---------------------------------------------------------------------------


def test_every_model_file_takes_the_warp_kernel():
  """Every committed model file's (nv, nefc) routes to the warp kernel, so
  no shape that ran before the wide route changes kernel; nv 40 at its
  shared memory's edge does too, and one row more goes wide."""
  from myosuite_tpu_torch.mjcf import export
  from myosuite_tpu_torch.physics import io as tio
  shapes = set()
  for name in sorted(export.SOURCES):
    m, _ = tio.load_model(os.path.join(registry.ASSETS, name), "cpu")
    shapes.add((m.nv, m.plan["constraint"].nefc))
  assert {nk.route(*s) for s in shapes} == {"warp"}, shapes
  assert (38, 336) in shapes
  edge = max(n for n in range(2000) if nk.warp_smem_per_env(38, n)
             <= nk._SMEM_LIMIT)
  assert (nk.route(38, edge), nk.route(38, edge + 1)) == ("warp", "wide")
  assert (nk.route(40, 9), nk.route(41, 9)) == ("warp", "wide")


def test_scene_is_jax_scene_and_compiled_copy_holds():
  """The scene's MJCF from the port's builders is the JAX package's; its
  committed compiled copy (what the card, which has no MuJoCo, loads for
  this model_xml) equals a fresh compile field for field, and the
  model_xml route takes it where MuJoCo cannot be imported."""
  from myosuite_tpu_torch.mjcf import export
  from myosuite_tpu_torch.physics import io as tio
  xml = scene_xml()
  assert xml == jax_scene_xml()
  name = "myoarm_relocate.npz"
  fresh, extra = export.load_xml(xml, name, "cpu")
  with np.load(export.compiled_path(xml, name)) as z:
    copy = {k: z[k] for k in z.files}
  fields = tio.model_fields(tio.compile_mjcf(xml))
  for k, v in fields.items():
    np.testing.assert_array_equal(copy[k], v, err_msg=k)

  def no_mujoco(_):
    raise ImportError("no MuJoCo here")

  orig = tio.compile_mjcf
  tio.compile_mjcf = no_mujoco
  try:
    model, extra_copy = export.load_xml(xml, name, "cpu")
    with pytest.raises(ImportError):
      export.load_xml(xml.replace("clutter_1", "clutter_2"), name, "cpu")
  finally:
    tio.compile_mjcf = orig
  assert (model.nv, model.plan["constraint"].nefc) == SCENE_SHAPE
  assert sorted(extra_copy) == sorted(extra)
  for k in extra:
    np.testing.assert_array_equal(extra_copy[k], extra[k], err_msg=k)


def test_port_replays_wide_golden():
  """MtxRelocate-v0 under the cluttered scene's model_xml, on the CPU: nv
  45 and 375 rows take the wide route, and the JAX package's trajectory
  replays from its reset within the tolerances stored beside it
  (chip_smoke.py phase 16 uses them too)."""
  golden = _golden()
  assert str(golden["scene_xml"]) == scene_xml()
  env = registry.make("MtxRelocate-v0", device="cpu",
                      overrides={"model_xml": scene_xml()})
  m = env.model
  assert (m.nv, m.plan["constraint"].nefc) == SCENE_SHAPE
  assert nk.route(*SCENE_SHAPE) == "wide"
  ours = port_replay(golden, "cpu")
  for k in GOLDEN_FIELDS:
    assert_close(f"wide {k}", ours[k], golden[k],
                 atol=float(golden["atol_" + k]))


@pytest.mark.slow
def test_wide_golden_in_sync_with_jax():
  """The JAX package still produces the committed trajectory (~20 min on
  a CPU: the arm runs op by op, hence slow)."""
  golden = _golden()
  for k, v in _jax_golden_in_process().items():
    np.testing.assert_allclose(golden[k], v, rtol=1e-6, atol=1e-6,
                               err_msg=k)


if __name__ == "__main__":
  if sys.argv[1:2] == ["--jax-golden"]:
    np.savez(sys.argv[2], **jax_golden())
  else:
    write_golden()

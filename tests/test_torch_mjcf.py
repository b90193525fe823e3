"""The port's MJCF builders, model export, `model_xml` route and passive
viewer against the JAX package's.

- Builder strings: for every committed model file, the port's builder call
  (`mjcf.export.SOURCES`) gives the string the JAX package's registry
  builds for it (captured where the JAX registry makes it, by stopping
  its `finalize_muscles` at the call). String comparisons, milliseconds.
- The finished MJCF (`export.model_xml`: length ranges swept, the two
  edited arm files through MjSpec) equals JAX's, and `export.export`
  equals the committed file key by key, dtype by dtype, bit by bit: the
  elbow and the finger here, every other file under `-m slow`.
- The length-range sweep through the port's kinematics (`mjcf.sweep`, the
  function phase 15 runs on the card) stays within 5e-6 m of the
  committed ranges, but for `sweep.MIRRORED_ROWS`, where the JAX engine's
  tendon path leaves MuJoCo's: the port's sweep equals the JAX engine's
  there (slow).
- `make(id, overrides={"model_xml": xml})`: the elbow from its own MJCF
  equals the committed-file env bit for bit; a heavier forearm matches JAX
  `make` with the same `config_overrides` over 2 control steps; without
  MuJoCo the route raises the MuJoCo ImportError.
- `PassiveViewer`: RuntimeError without DISPLAY, and with a stand-in for
  `mujoco.viewer.launch_passive`, `sync` copies the chosen row.
"""

import functools
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import myosuite_tpu
import myosuite_tpu_torch
from myosuite_tpu.assets import builder as jbuilder
from myosuite_tpu.assets import editor as jeditor
from myosuite_tpu.assets import hand as jhand
from myosuite_tpu.assets import leg as jleg
from myosuite_tpu.assets import torso as jtorso
from myosuite_tpu.envs import myodm as jmyodm
from myosuite_tpu.envs import registry as jax_registry
from myosuite_tpu_torch.envs import registry
from myosuite_tpu_torch.mjcf import builder, export, sweep
from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.renderer import PassiveViewer
from tests.test_torch_step import TRAJ_ATOL
from tests.torch_common import (CHALLENGE_IDS, EXPORTS, MANIP_IDS,
                                assert_close)

NAMES = sorted(export.SOURCES)
TIER1 = ("myoelbow.npz", "myofinger.npz")
SWEEP_TOL = 5e-6     # m: the MJCF's %.6f rounding and float32
NAMED_TOL = 1e-6     # m: an edited file's ranges against myoarm.npz's


def _tiered(names):
  """`names` as parameters, all but TIER1 marked slow."""
  return [pytest.param(n, marks=() if n in TIER1 else pytest.mark.slow)
          for n in names]


class _Captured(Exception):
  pass


def _captured(fn):
  """The string the JAX package hands to its finalize_muscles when `fn`
  runs (which then stops)."""
  def record(xml, nsamples=64):
    raise _Captured(xml)
  with mock.patch.object(jbuilder, "finalize_muscles", record):
    try:
      fn()
    except _Captured as c:
      return c.args[0]
  raise AssertionError("finalize_muscles was not called")


def _jax_factory(env_id):
  return functools.partial(jax_registry._REGISTRY[env_id], None)


# The JAX package's builder call for each committed model file: the
# registry's own calls where it makes them when an env is built, else the
# calls it makes at import (`_register_all`), restated.
_JAX_SOURCES = {
    "myohand_reach.npz": jhand.build_hand,
    "myoelbow.npz": jbuilder.build_elbow,
    "myofinger.npz": jbuilder.build_finger,
    "myoleg.npz": jleg.build_leg,
    "myoleg_terrain.npz": functools.partial(jleg.build_leg, terrain=True),
    "myotorso.npz": jtorso.build_torso,
    "myoarm.npz": functools.partial(jhand.build_hand, arm=True),
    "myoarm_reach.npz": functools.partial(_captured,
                                          jeditor.build_arm_reach_xml),
    **{f"myohand_{obj}.npz": functools.partial(_captured, _jax_factory(i))
       for obj, i in MANIP_IDS.items()},
    **{f"myodm/{obj}.npz": functools.partial(
        _captured, functools.partial(jmyodm.scene_xml.__wrapped__, obj))
       for obj in jmyodm.GRAB_OBJECTS},
    **{name: functools.partial(_captured, _jax_factory(i))
       for name, i in CHALLENGE_IDS.items()},
}


def _jax_model_xml(name):
  """The JAX package's finished MJCF of a committed model file."""
  if name == "myoarm_reach.npz":
    return jeditor.build_arm_reach_xml()
  if name == "myoarm_tabletennis.npz":
    return jeditor.build_tabletennis_xml()
  return jbuilder.finalize_muscles(_JAX_SOURCES[name]())


_JAX_SOURCES["myoarm_tabletennis.npz"] = functools.partial(
    _captured, _jax_factory("MtxTableTennis-v0"))


def test_every_committed_file_has_a_source():
  assert sorted(EXPORTS) == NAMES == sorted(_JAX_SOURCES)
  assert len(NAMES) == 69


@pytest.mark.parametrize("name", NAMES)
def test_builder_string_matches_jax(name):
  """The port's builder string of each committed file is JAX's, character
  for character (before the sweep)."""
  assert export.SOURCES[name]() == _JAX_SOURCES[name]()


def test_myodm_scene_passes_its_snippet_without_touching_the_tables():
  """scene_builder_xml hands its object to build_hand as arguments: the
  port's OBJECT_SNIPPETS / OBJECT_ASSETS stay as they are."""
  from myosuite_tpu_torch.envs import myodm
  from myosuite_tpu_torch.mjcf import hand
  before = (dict(hand.OBJECT_SNIPPETS), dict(hand.OBJECT_ASSETS))
  xml = myodm.scene_builder_xml("cup")
  assert 'mesh="grab_cup"' in xml and '<mesh name="grab_cup"' in xml
  assert (hand.OBJECT_SNIPPETS, hand.OBJECT_ASSETS) == before


@pytest.mark.parametrize("name", _tiered(NAMES))
def test_model_xml_matches_jax(name):
  """The finished MJCF: the same muscle length ranges (%.6f), and for the
  two edited arm files the same MjSpec round trip."""
  assert export.model_xml(name) == _jax_model_xml(name)


def _assert_export_is_committed(name):
  fields, extra = export.export(name)
  fresh = {**fields, **extra}
  with np.load(os.path.join(registry.ASSETS, name)) as z:
    committed = {k: z[k] for k in z.files}
  assert sorted(committed) == sorted(fresh)
  for k, v in fresh.items():
    c = committed[k]
    assert c.dtype == v.dtype and c.shape == v.shape, k
    assert np.array_equal(c, v), k   # bit-equal floats, exact ints


@pytest.mark.parametrize("name", _tiered(NAMES))
def test_export_equals_committed_file(name):
  _assert_export_is_committed(name)


def test_export_imports_no_jax_package():
  """The exporter and the builders run in a process where the JAX package,
  jax, flax and ml_collections cannot be imported."""
  import subprocess
  code = ("import sys\n"
          "for m in ('jax', 'flax', 'ml_collections', 'myosuite_tpu'):\n"
          "  sys.modules[m] = None\n"
          "import numpy as np\n"
          "from myosuite_tpu_torch.mjcf import export\n"
          "from myosuite_tpu_torch.envs.registry import FINGER_NPZ\n"
          "fields, extra = export.export('myofinger.npz')\n"
          "with np.load(FINGER_NPZ) as z:\n"
          "  assert all(np.array_equal(z[k], v) for k, v in\n"
          "             {**fields, **extra}.items())\n"
          "print('ok')\n")
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == "ok"


def test_write_puts_the_file_where_asked(tmp_path):
  """write() and the CLI's --out write the exported file under the given
  directory (subdirectories made), readable by load_model."""
  path = export.write("myoelbow.npz", str(tmp_path))
  assert path == str(tmp_path / "myoelbow.npz")
  fields, extra = export.export("myoelbow.npz")
  with np.load(path) as z:
    assert sorted(z.files) == sorted({**fields, **extra})
  export.main(["myofinger.npz", "myodm/apple.npz", "--out", str(tmp_path)])
  _, got = physics_io.load_model(str(tmp_path / "myofinger.npz"), "cpu")
  assert np.array_equal(got["cfg_reach_tip_sids"],
                        export.export("myofinger.npz")[1]["cfg_reach_tip_sids"])
  assert (tmp_path / "myodm" / "apple.npz").exists()


@pytest.mark.parametrize("name", ["myoelbow.npz", "myofinger.npz"])
def test_sweep_holds_the_committed_ranges(name):
  """Phase 15's sweep on the CPU: every muscle within 5e-6 m of the
  committed length range."""
  model, _ = physics_io.load_model(os.path.join(registry.ASSETS, name), "cpu")
  rows, swept, gaps = sweep.sweep_gaps(model)
  print(f"{name}: {len(rows)} muscles, largest gap {gaps.max():.3e} m")
  assert len(rows) == model.nu and gaps.max() <= SWEEP_TOL


_JOINTS_XML = """<mujoco><worldbody>
  <body name="a"><freejoint/><geom size="0.1"/>
    <body name="b" pos="0 0 -0.2"><joint type="ball"/><geom size="0.1"/>
      <body name="c" pos="0 0 -0.2">
        <joint name="h" type="hinge" limited="true" range="-0.4 0.7"/>
        <joint name="u" type="hinge" limited="false"/>
        <joint name="s" type="slide" limited="true" range="0 0.05"/>
        <geom size="0.1"/></body></body></body>
</worldbody></mujoco>"""


def test_sweep_samples_match_the_builders_draws():
  """sweep_qpos is the sample set of the JAX finalize_muscles loop: lows,
  highs, then RandomState(0) per joint in joint order; only each joint's
  first qpos coordinate is set (a free joint's x, a ball joint's w), the
  rest stays at qpos0, unlimited joints in [-1.5, 1.5]."""
  mj = mujoco.MjModel.from_xml_string(_JOINTS_XML)
  q = builder.sweep_qpos(mj.qpos0, mj.jnt_qposadr, mj.jnt_range,
                         mj.jnt_limited, 5)
  assert q.shape == (5, mj.nq) and q.dtype == np.float64
  lo = np.where(mj.jnt_limited, mj.jnt_range[:, 0], -1.5)
  hi = np.where(mj.jnt_limited, mj.jnt_range[:, 1], 1.5)
  np.testing.assert_array_equal(q[0, mj.jnt_qposadr], lo)
  np.testing.assert_array_equal(q[1, mj.jnt_qposadr], hi)
  rest = np.setdiff1d(np.arange(mj.nq), mj.jnt_qposadr)
  np.testing.assert_array_equal(q[:, rest], np.tile(mj.qpos0[rest], (5, 1)))
  rng = np.random.RandomState(0)
  for s in range(2, 5):
    for j, adr in enumerate(mj.jnt_qposadr):
      assert q[s, adr] == rng.uniform(lo[j], hi[j])


def test_edited_arm_files_keep_the_arms_ranges():
  """myoarm_reach.npz and myoarm_tabletennis.npz, edited after the sweep,
  keep each muscle's range of myoarm.npz (by name) within 1e-6 m."""
  path = lambda n: os.path.join(registry.ASSETS, n)
  arm, arm_extra = physics_io.load_model(path("myoarm.npz"), "cpu")
  for name in export.EDITS:
    model, extra = physics_io.load_model(path(name), "cpu")
    gap = sweep.named_range_gap(model, extra["actuator_names"], arm,
                                arm_extra["actuator_names"])
    print(f"{name}: largest gap {gap:.3e} m")
    assert len(sweep.muscle_rows(model)) > 0 and gap <= NAMED_TOL


@pytest.mark.slow
def test_sweep_misses_exactly_the_mirrored_rows():
  """Over every finalized committed file, the port's sweep is within 5e-6
  m of the stored ranges except on sweep.MIRRORED_ROWS, where it misses by
  more than 1 cm."""
  for name in NAMES:
    if name in export.EDITS:
      continue
    model, _ = physics_io.load_model(os.path.join(registry.ASSETS, name),
                                     "cpu")
    rows, _, gaps = sweep.sweep_gaps(model)
    missed = tuple(int(r) for r in rows[gaps > SWEEP_TOL])
    assert missed == sweep.MIRRORED_ROWS.get(name, ()), name
    assert all(gaps[np.isin(rows, missed)] > 1e-2), name


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(sweep.MIRRORED_ROWS))
def test_mirrored_rows_follow_the_jax_engine(name):
  """On every file with mirrored rows, the JAX engine's tendon path gives
  the port's sweep (its kinematics, tendon and transmission under vmap on
  the same samples) within 1e-6 m on every muscle, and both leave
  MuJoCo's on MIRRORED_ROWS."""
  from myosuite_tpu.physics import actuation as jact
  from myosuite_tpu.physics import io as jio
  from myosuite_tpu.physics import kinematics as jkin
  from myosuite_tpu.physics import tendon as jten
  m, mj = jio.load_model(xml=export.model_xml(name))
  q = builder.sweep_qpos(mj.qpos0, mj.jnt_qposadr, mj.jnt_range,
                         mj.jnt_limited)

  def lengths(qpos):
    d = jio.make_data(m).replace(qpos=qpos)
    d = jten.tendon(m, jkin.com_pos(m, jkin.kinematics(m, d)))
    return jact.transmission(m, d).actuator_length

  # eager vmap: one XLA compile of the whole arm or leg takes minutes
  got = np.asarray(jax.vmap(lengths)(jnp.asarray(q, jnp.float32)),
                   dtype=np.float64)
  jax_range = np.stack(builder.pad_lengthrange(got.min(0), got.max(0)), 1)
  model = physics_io.model_from_numpy(physics_io.model_fields(mj), "cpu")
  ours = sweep.sweep_lengthrange(model)
  assert_close(f"{name} sweep, port vs JAX engine", ours, jax_range,
               atol=1e-6)
  rows = list(sweep.MIRRORED_ROWS[name])
  stored = mj.actuator_lengthrange[rows]
  assert np.all(np.abs(jax_range[rows] - stored).max(1) > 1e-2)


# ---------------------------------------------------------------------------
# the model_xml route and the host model
# ---------------------------------------------------------------------------


def _roll(env, batch=4, steps=2, seed=0):
  gen = torch.Generator().manual_seed(seed)
  state = env.reset(gen, batch)
  out = [state]
  for _ in range(steps):
    state = env.step(state, torch.rand(batch, env.action_size,
                                       generator=gen))
    out.append(state)
  return out


def test_model_xml_route_on_the_elbows_own_mjcf():
  """make(..., overrides={"model_xml": the elbow's MJCF}) is the committed
  file's env: the same fields and extras, and 2 control steps bit-equal."""
  xml = export.model_xml("myoelbow.npz")
  env = registry.make("MtxElbowPoseRandom-v0", "cpu")
  mine = registry.make("MtxElbowPoseRandom-v0", "cpu", {"model_xml": xml})
  assert mine.config["model_xml"] == xml
  assert mine.config["model_file"] == env.config["model_file"] == \
      "myoelbow.npz"
  for a, b in zip(_roll(env), _roll(mine)):
    for k in ("qpos", "qvel", "act"):
      assert torch.equal(getattr(a.data, k), getattr(b.data, k)), k
    assert torch.equal(a.obs["state"], b.obs["state"])
    assert torch.equal(a.reward, b.reward)


def test_model_xml_route_heavier_forearm_matches_jax():
  """An edited elbow (forearm 1.1 -> 2.5 kg) through both packages' make
  with the same model_xml: the JAX env's reset poses and targets, the same
  actions, 2 control steps, to TRAJ_ATOL."""
  xml = export.model_xml("myoelbow.npz")
  heavy = xml.replace('size="0.022" mass="1.1"', 'size="0.022" mass="2.5"')
  assert heavy != xml
  env_id, b = "MtxElbowPoseRandom-v0", 4
  jenv = myosuite_tpu.make(env_id, config_overrides={"model_xml": heavy})
  jstate = jax.jit(jax.vmap(jenv.reset))(
      jax.random.split(jax.random.PRNGKey(0), b))
  jstep = jax.jit(jax.vmap(jenv.step))
  tenv = myosuite_tpu_torch.make(env_id, device="cpu",
                                 overrides={"model_xml": heavy})
  light = registry.make(env_id, "cpu")
  assert float(tenv.model.body_mass[2] - light.model.body_mass[2]) == \
      pytest.approx(1.4)                  # the forearm's ulna geom
  qpos = torch.from_numpy(np.array(jstate.data.qpos))
  targets = torch.from_numpy(np.array(jstate.info["target_angles"]))
  tenv._sample_qpos = lambda generator, batch: qpos.clone()
  tenv._sample_target = lambda generator, batch: targets.clone()
  tstate = tenv.reset(torch.Generator().manual_seed(0), b)
  rng = np.random.default_rng(3)
  # through numpy: the JAX step's metrics come out weak-typed, which would
  # make the jitted step compile a second time
  strong = lambda tree: jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                                     tree)
  for i in range(2):
    a = rng.uniform(-1, 1, (b, tenv.action_size)).astype(np.float32)
    jstate = strong(jstep(jstate, jnp.asarray(a)))
    tstate = tenv.step(tstate, torch.from_numpy(a))
    assert_close(f"heavy elbow step {i + 1} obs", tstate.obs["state"],
                 np.asarray(jstate.obs["state"]), atol=TRAJ_ATOL)
    assert_close(f"heavy elbow step {i + 1} reward", tstate.reward,
                 np.asarray(jstate.reward), atol=TRAJ_ATOL)


def test_model_xml_route_without_mujoco_raises(monkeypatch):
  """Without MuJoCo the route, and `put_model` of an MJCF string (the one
  compile path), raise the MuJoCo ImportError; the route never loads the
  committed file instead. The committed file still loads."""
  monkeypatch.setitem(sys.modules, "mujoco", None)
  with pytest.raises(ImportError, match="MuJoCo"):
    registry.make("MtxElbowPoseRandom-v0", "cpu",
                  {"model_xml": builder.build_elbow()})
  with pytest.raises(ImportError, match="MuJoCo"):
    physics_io.put_model(builder.build_elbow(), "cpu")
  env = registry.make("MtxElbowPoseRandom-v0", "cpu")
  with pytest.raises(ImportError, match="MuJoCo"):
    env.mj_model


def test_mj_model_is_the_jax_envs():
  """env.mj_model, compiled at first use from the exporter's MJCF, has the
  JAX env's host model's fields."""
  env = registry.make("MtxFingerReachRandom-v0", "cpu")
  assert env._mj_model is None
  ours = physics_io.model_fields(env.mj_model)
  theirs = physics_io.model_fields(
      myosuite_tpu.make("MtxFingerReachRandom-v0").mj_model)
  assert sorted(ours) == sorted(theirs)
  for k, v in theirs.items():
    assert np.array_equal(ours[k], v), k


# ---------------------------------------------------------------------------
# PassiveViewer
# ---------------------------------------------------------------------------


def test_passive_viewer_needs_a_display(monkeypatch):
  monkeypatch.delenv("DISPLAY", raising=False)
  monkeypatch.setattr(sys, "platform", "linux")
  env = registry.make("MtxElbowPoseRandom-v0", "cpu")
  with pytest.raises(RuntimeError, match="DISPLAY"):
    PassiveViewer(env)


class _FakeViewer:
  def __init__(self, model, data, key_callback=None):
    self.model, self.data, self.key = model, data, key_callback
    self.syncs, self.closed = 0, False

  def is_running(self):
    return not self.closed

  def sync(self):
    self.syncs += 1

  def close(self):
    self.closed = True


def test_passive_viewer_syncs_the_chosen_row(monkeypatch):
  """With launch_passive stood in for, sync copies row 0 (or the row
  asked for) of a batched Data to the host MjData and runs mj_forward;
  SPACE toggles the pause."""
  import mujoco.viewer
  monkeypatch.setenv("DISPLAY", ":0")
  opened = []
  monkeypatch.setattr(mujoco.viewer, "launch_passive",
                      lambda m, d, key_callback=None: opened.append(
                          _FakeViewer(m, d, key_callback)) or opened[-1])
  env = registry.make("MtxFingerPoseRandom-v0", "cpu")
  state = _roll(env, batch=3, steps=1)[-1]
  with PassiveViewer(env, realtime=False) as viewer:
    fake = opened[0]
    assert fake.model is env.mj_model
    viewer.sync(state.data, row=1)
    np.testing.assert_array_equal(fake.data.qpos,
                                  state.data.qpos[1].double().numpy())
    np.testing.assert_array_equal(fake.data.qvel,
                                  state.data.qvel[1].double().numpy())
    d = mujoco.MjData(env.mj_model)
    d.qpos[:] = state.data.qpos[1].double().numpy()
    mujoco.mj_forward(env.mj_model, d)
    np.testing.assert_array_equal(fake.data.site_xpos, d.site_xpos)
    viewer.sync(state.data)
    np.testing.assert_array_equal(fake.data.qpos,
                                  state.data.qpos[0].double().numpy())
    assert fake.syncs == 2 and viewer.is_running()
    fake.key(32)
    assert viewer._paused
    fake.key(32)
  assert fake.closed


@pytest.mark.slow
def test_passive_viewer_copies_the_mocap_bodies(monkeypatch):
  """ChaseTag's opponent is a mocap body: sync copies its pose of the row."""
  import mujoco.viewer
  monkeypatch.setenv("DISPLAY", ":0")
  opened = []
  monkeypatch.setattr(mujoco.viewer, "launch_passive",
                      lambda m, d, key_callback=None: opened.append(
                          _FakeViewer(m, d, key_callback)) or opened[-1])
  env = registry.make("MtxChaseTag-v0", "cpu")
  state = env.reset(torch.Generator().manual_seed(0), 2)
  with PassiveViewer(env, realtime=False) as viewer:
    viewer.sync(state.data, row=1)
    n = env.mj_model.nmocap
    assert n == 1
    np.testing.assert_array_equal(
        opened[0].data.mocap_pos, state.data.mocap_pos[1, :n].double().numpy())

"""The port's user tools against the JAX package's, on the CPU: the robot
layer, inverse kinematics, trajectories, curriculum, quaternion and vector
math, the trace logger and its native sink, RoboSet traces, examine_logs'
playback and the examine_env CLI.

The same numpy inputs go to both packages; where the JAX function draws
(sensor noise), the port is checked against its own generator's draws.
The model is the finger (nv 4) of the committed model file, whose fields
the JAX package's model exports. The hand's IK is left to the card: its
JAX IK takes ~30 s to compile here, and chip_smoke.py phase 13 holds the
port's IK at batch 4096 on the card against the port on the CPU.
Tolerances are stated in each test.
"""

import io
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
import myosuite_tpu_torch
from myosuite_tpu import native as jnative
from myosuite_tpu.logger import roboset as jroboset
from myosuite_tpu.logger import trace as jtrace
from myosuite_tpu.physics import io as jio
from myosuite_tpu.physics import math as jmath
from myosuite_tpu.robot import robot as jrobot
from myosuite_tpu.utils import curriculum as jcurriculum
from myosuite_tpu.utils import examine_env as jexamine_env
from myosuite_tpu.utils import inverse_kinematics as jik
from myosuite_tpu.utils import quat_math as jquat
from myosuite_tpu.utils import trajectories as jtraj
from myosuite_tpu.utils import vector_math as jvec
from myosuite_tpu_torch import native
from myosuite_tpu_torch.logger import examine_logs, roboset, trace
from myosuite_tpu_torch.physics import io as pio
from myosuite_tpu_torch.physics import kinematics
from myosuite_tpu_torch.robot import robot
from myosuite_tpu_torch.utils import (curriculum, examine_env,
                                      inverse_kinematics, quat_math,
                                      trajectories, vector_math)
from tests.torch_common import assert_close

FINGER = "MtxFingerReachFixed-v0"
B = 4


def _pair(env_id):
  """(JAX env, port env on the CPU) of one id."""
  return (myosuite_tpu.make(env_id),
          myosuite_tpu_torch.make(env_id, device="cpu"))


def _states(m, rng, batch=B, spread=0.3):
  """qpos inside the joint ranges (numpy, float32) and qvel."""
  lo, hi = np.asarray(m.jnt_range).T
  mid = np.where(hi > lo, (lo + hi) / 2, 0.0)
  half = np.where(hi > lo, (hi - lo) / 2, 0.0)
  qpos = mid + spread * half * rng.uniform(-1, 1, (batch, m.nq))
  qvel = rng.normal(0, 0.5, (batch, m.nv))
  return qpos.astype(np.float32), qvel.astype(np.float32)


def _jax_data(m, qpos, qvel, act=None):
  """A batch of JAX Data at the supplied state."""
  d0 = jio.make_data(m)
  def one(q, v, a):
    d = d0.replace(qpos=q, qvel=v)
    return d if a is None else d.replace(act=a)
  return jax.vmap(one)(jnp.asarray(qpos), jnp.asarray(qvel),
                       None if act is None else jnp.asarray(act))


# -- robot -------------------------------------------------------------------

def _robot_inputs(env):
  rng = np.random.default_rng(0)
  qpos, qvel = _states(env.model, rng)
  act = rng.uniform(0, 1, (B, env.model.na)).astype(np.float32)
  alen = rng.normal(0, 0.05, (B, env.model.nu)).astype(np.float32)
  ctrl = rng.uniform(-1.5, 1.5, (B, env.model.nu)).astype(np.float32)
  jd = types.SimpleNamespace(time=jnp.zeros(B), qpos=jnp.asarray(qpos),
                             qvel=jnp.asarray(qvel), act=jnp.asarray(act),
                             actuator_length=jnp.asarray(alen))
  d = pio.make_data(env.model, B).replace(
      qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel),
      act=torch.from_numpy(act), actuator_length=torch.from_numpy(alen))
  return jd, d, ctrl


@pytest.mark.parametrize("vel_limit", [None, 2.0])
def test_robot_matches_jax(vel_limit):
  """get_sensors (no noise), normalize_actions and process_actuator on
  supplied states and controls of the finger: bit for bit with the JAX
  functions (the same elementwise float32 ops)."""
  jenv, env = _pair(FINGER)
  jd, d, ctrl = _robot_inputs(env)
  jr = jrobot.Robot(jenv.model, vel_limit=vel_limit)
  r = robot.Robot(env.model, vel_limit=vel_limit)
  for k, v in jr.get_sensors(jd).items():
    np.testing.assert_array_equal(r.get_sensors(d)[k].numpy(),
                                  np.asarray(v), err_msg=k)
  np.testing.assert_array_equal(
      r.normalize_actions(torch.from_numpy(ctrl)).numpy(),
      np.asarray(jr.normalize_actions(jnp.asarray(ctrl))))
  np.testing.assert_array_equal(
      r.process_actuator(d, torch.from_numpy(ctrl), 0.02).numpy(),
      np.asarray(jr.process_actuator(jd, jnp.asarray(ctrl), 0.02)))


def test_robot_noise_and_sensor_cache():
  """With noise, the port's draws are its generator's, qpos then qvel
  (none without a generator); the sensor cache keeps its depth and
  clamps a delay to its history."""
  env = myosuite_tpu_torch.make(FINGER, device="cpu")
  _, d, _ = _robot_inputs(env)
  noisy = robot.Robot(env.model, sensor_noise=0.1)
  gen = torch.Generator().manual_seed(3)
  got = noisy.get_sensors(d, gen)
  gen.manual_seed(3)
  for k in ("qpos", "qvel"):
    want = getattr(d, k) + 0.1 * torch.randn(getattr(d, k).shape,
                                             generator=gen)
    assert torch.equal(got[k], want), k
  assert torch.equal(noisy.get_sensors(d)["qpos"], d.qpos)
  cache = robot.SensorCache(depth=3)
  for i in range(5):
    cache.append({"t": i})
  assert len(cache) == 3 and cache.latest() == {"t": 4}
  assert cache.delayed(1) == {"t": 3} and cache.delayed(9) == {"t": 2}


SENSOR2SIM_FIELDS = ("xpos", "xquat", "site_xpos", "subtree_com", "cdof",
                     "ten_length", "actuator_length", "actuator_moment",
                     "qM", "cvel", "ten_velocity", "actuator_velocity",
                     "qfrc_bias", "qfrc_passive")


def test_sensor2sim_matches_jax():
  """sensor2sim of supplied sensors on the finger against the JAX
  package's (jit of vmap): every derived field within 1e-5 of
  max(1, its scale); on noise-free sensors of a settled state it gives
  that state's own kinematics back bit for bit."""
  jenv, env = _pair(FINGER)
  rng = np.random.default_rng(1)
  qpos, qvel = _states(jenv.model, rng)
  act = rng.uniform(0, 1, (B, env.model.na)).astype(np.float32)
  jm = jenv.model
  want = jax.jit(jax.vmap(lambda d: jrobot.sensor2sim(
      jm, d, {"qpos": d.qpos, "qvel": d.qvel, "act": d.act})))(
          _jax_data(jm, qpos, qvel, act))
  d = pio.make_data(env.model, B)
  got = robot.sensor2sim(env.model, d, {
      "qpos": torch.from_numpy(qpos), "qvel": torch.from_numpy(qvel),
      "act": torch.from_numpy(act)})
  for k in SENSOR2SIM_FIELDS:
    ref = np.asarray(getattr(want, k))
    assert_close(f"sensor2sim {k}", getattr(got, k), ref,
                 atol=1e-5 * max(1.0, float(np.abs(ref).max())))
  state = env.reset(torch.Generator().manual_seed(0), B)
  back = robot.sensor2sim(env.model, state.data,
                          robot.Robot(env.model).get_sensors(state.data))
  for k in SENSOR2SIM_FIELDS:
    assert torch.equal(getattr(back, k), getattr(state.data, k)), k


# -- inverse kinematics ------------------------------------------------------

def _site(env, name):
  return next(i for i in range(env.mj_model.nsite)
              if name in env.mj_model.site(i).name)


@pytest.mark.parametrize("env_id,site,with_quat,tol", [
    (FINGER, "IFtip", False, 1.5e-3), (FINGER, "IFtip", True, 2e-3)])
def test_ik_matches_jax(env_id, site, with_quat, tol):
  """qpos_from_site_pose from supplied qposes to targets taken from the
  forward kinematics of perturbed qposes (position, and the site's
  orientation when with_quat): the same step count per env as the JAX
  function (jit of vmap), qpos within 1e-5 and err_norm within 1e-5 of
  the JAX results; at least one env stops inside the loop."""
  jenv = myosuite_tpu.make(env_id)
  env = myosuite_tpu_torch.make(env_id, device="cpu")
  m, jm = env.model, jenv.model
  sid = _site(jenv, site)
  rng = np.random.default_rng(2)
  lo, hi = np.asarray(jm.jnt_range).T
  q0 = ((lo + hi) / 2 + 0.2 * (hi - lo) / 2 * rng.uniform(
      -1, 1, (B, jm.nq))).astype(np.float32)
  qt = np.clip(q0 + rng.uniform(-0.3, 0.3, q0.shape),
               *np.asarray(jm.jnt_range).T).astype(np.float32)
  q0[0] = qt[0] + 1e-3     # one env starts next to its target
  dt = kinematics.kinematics(m, pio.make_data(m, B).replace(
      qpos=torch.from_numpy(qt)))
  pos = dt.site_xpos[:, sid]
  tq = (torch.from_numpy(np.asarray(jax.vmap(jmath.mat_to_quat)(
      jnp.asarray(dt.site_xmat[:, sid].numpy())))) if with_quat else None)
  d = pio.make_data(m, B).replace(qpos=torch.from_numpy(q0))
  got = inverse_kinematics.qpos_from_site_pose(m, d, sid, pos, tq, tol=tol)
  if with_quat:
    want = jax.jit(jax.vmap(lambda dd, p, q: jik.qpos_from_site_pose(
        jm, dd, sid, p, q, tol=tol)))(_jax_data(jm, q0, np.zeros_like(q0)),
                                      jnp.asarray(pos.numpy()),
                                      jnp.asarray(tq.numpy()))
  else:
    want = jax.jit(jax.vmap(lambda dd, p: jik.qpos_from_site_pose(
        jm, dd, sid, p, tol=tol)))(_jax_data(jm, q0, np.zeros_like(q0)),
                                   jnp.asarray(pos.numpy()))
  print(f"{env_id} {site} quat {with_quat}: steps {got.steps.tolist()}, "
        f"err_norm {got.err_norm.tolist()}")
  np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
  assert_close("ik qpos", got.qpos, want.qpos, atol=1e-5)
  assert_close("ik err_norm", got.err_norm, want.err_norm, atol=1e-5)
  steps = got.steps.numpy()
  assert ((steps > 0) & (steps < 50)).any(), steps


# -- small math --------------------------------------------------------------

def _rotations(rng, n):
  """Rotation matrices covering all four of Shepperd's cases."""
  q = rng.normal(0, 1, (n, 4))
  q[:4] = np.eye(4) + 0.05 * rng.normal(0, 1, (4, 4))   # w, x, y, z lead
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  return np.array(jax.vmap(jmath.quat_to_mat)(jnp.asarray(q)),
                  dtype=np.float32)


def _quat_inputs():
  """Supplied inputs: n rotations covering Shepperd's four cases, unit
  quaternions, euler angles, vectors, axes and angles."""
  rng = np.random.default_rng(3)
  n = 12
  unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
      np.float32)
  qa, qb = unit(rng.normal(0, 1, (n, 4))), unit(rng.normal(0, 1, (n, 4)))
  vec = rng.normal(0, 1, (n, 3)).astype(np.float32)
  return dict(mats=_rotations(rng, n), qa=qa, qb=qb, vec=vec,
              eul=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
              axis=unit(vec), ang=rng.uniform(-3, 3, n).astype(np.float32))


QUAT_CASES = {
    "mulQuat": ("qa", "qb"), "negQuat": ("qa",), "quat2Vel": ("qa",),
    "diffQuat": ("qa", "qb"), "quatDiff2Vel": ("qa", "qb"),
    "axis_angle2quat": ("axis", "ang"), "euler2quat": ("eul",),
    "quat2mat": ("qa",), "mat2quat": ("mats",), "rotVecQuat": ("vec", "qa"),
    "quat2euler": ("qa",), "mat2euler": ("mats",), "euler2mat": ("eul",)}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_math_matches_jax(name):
  """Each quat_math name on a batch against the JAX package's function
  vmapped over the same inputs: atol 1e-6."""
  x = _quat_inputs()
  args = [x[k] for k in QUAT_CASES[name]]
  want = jax.vmap(getattr(jquat, name))(*map(jnp.asarray, args))
  got = getattr(quat_math, name)(*map(torch.from_numpy, args))
  assert_close(f"quat_math {name}", got, want, atol=1e-6)


def test_quat_integrate_and_cosine_match_jax():
  """quatIntegrate and calculate_cosine (zero vectors included) against
  the JAX package's: atol 1e-6."""
  x = _quat_inputs()
  got = quat_math.quatIntegrate(torch.from_numpy(x["qa"]),
                                torch.from_numpy(x["vec"]), 0.02)
  want = jax.vmap(lambda q, w: jquat.quatIntegrate(q, w, 0.02))(
      jnp.asarray(x["qa"]), jnp.asarray(x["vec"]))
  assert_close("quat_math quatIntegrate", got, want, atol=1e-6)
  a = np.concatenate([x["vec"], np.zeros((2, 3), np.float32)])
  b = np.concatenate([x["eul"], x["vec"][:2]])
  assert_close("calculate_cosine",
               vector_math.calculate_cosine(torch.from_numpy(a),
                                            torch.from_numpy(b)),
               jvec.calculate_cosine(a, b), atol=1e-6)


@pytest.mark.parametrize("name", ["min_jerk", "min_jerk_vel", "cyclic"])
def test_trajectories_match_jax(name):
  """min_jerk and min_jerk_vel (17 samples, also over a batch of
  endpoints) and cyclic: atol 1e-6."""
  rng = np.random.default_rng(4)
  x0, xf = rng.normal(0, 1, (2, 5)).astype(np.float32)
  if name == "cyclic":
    t = np.linspace(0, 3, 40, dtype=np.float32)
    assert_close(name, trajectories.cyclic(
        torch.tensor(0.7), 1.3, torch.tensor(0.2), torch.from_numpy(t)),
                 jtraj.cyclic(jnp.float32(0.7), 1.3, jnp.float32(0.2),
                              jnp.asarray(t)), atol=1e-6)
    return
  extra = (17,) if name == "min_jerk" else (17, 0.8)
  fn = getattr(trajectories, name)
  want = getattr(jtraj, name)(jnp.asarray(x0), jnp.asarray(xf), *extra)
  assert_close(name, fn(torch.from_numpy(x0), torch.from_numpy(xf),
                        *extra), want, atol=1e-6)
  batch = fn(torch.from_numpy(np.stack([x0, xf])),
             torch.from_numpy(np.stack([xf, x0])), *extra)
  assert batch.shape == (2, 17, 5)
  assert_close(name + " batch row", batch[0], want, atol=1e-6)


def test_curriculum_matches_jax():
  """12 updates on a supplied success sequence: equal levels and streaks
  after every update, capped at max_level."""
  js, ts = jcurriculum.init(1), curriculum.init(1, device="cpu")
  for rate in (0.9, 0.85, 0.2, 0.9, 0.9, 0.95, 0.8, 0.81, 0.99, 0.5, 0.9,
               0.9):
    js = jcurriculum.update(js, jnp.float32(rate), max_level=3)
    ts = curriculum.update(ts, torch.tensor(rate), max_level=3)
    assert (int(ts.level), int(ts.streak)) == (int(js.level),
                                               int(js.streak))
  assert int(ts.level) == 3


# -- traces ------------------------------------------------------------------

def _one_trace(mod):
  tr = mod.Trace("demo")
  rng = np.random.default_rng(5)
  for t in range(3):
    tr.append_datums("rollout0", {
        "obs": rng.normal(0, 1, 4).astype(np.float32),
        "qpos": rng.normal(0, 1, 2),
        "done": np.int32(t == 2), "flag": np.uint8(t), "half":
            np.float16(t / 3)})
  tr.create_group("empty")
  return tr


def test_mtp_files_are_byte_identical_to_jax(tmp_path, monkeypatch):
  """One trace saved as .mtp by the port (its native sink, and its Python
  writer) and by the JAX package: the same bytes; each package reads the
  other's file back equal."""
  monkeypatch.setenv("MTX_NATIVE_CACHE", str(tmp_path / "jax_native"))
  assert native.native_available()
  paths = {k: str(tmp_path / f"{k}.mtp") for k in ("port", "py", "jax")}
  _one_trace(trace).save(paths["port"])
  _one_trace(jtrace).save(paths["jax"])
  monkeypatch.setattr(native, "_library", lambda: None)
  _one_trace(trace).save(paths["py"])
  data = {k: open(p, "rb").read() for k, p in paths.items()}
  assert data["port"] == data["jax"] == data["py"]
  assert data["port"].startswith(native.MAGIC)
  ours, theirs = (native.read_tracepack(paths["jax"]),
                  jnative.read_tracepack(paths["port"]))
  assert sorted(ours) == sorted(theirs) == [
      f"rollout0/{k}" for k in ("done", "flag", "half", "obs", "qpos")]
  for k, v in ours.items():
    assert v.dtype == theirs[k].dtype
    np.testing.assert_array_equal(v, theirs[k])
  back = trace.Trace.load(paths["jax"])
  np.testing.assert_array_equal(back["rollout0"]["obs"],
                                _stacked(jtrace)["obs"])


def _stacked(mod):
  tr = _one_trace(mod)
  tr.stack()
  return tr["rollout0"]


@pytest.mark.parametrize("ext", [".pkl", ".h5"])
def test_trace_round_trips(ext, tmp_path):
  """save then load: every dataset equal, dtypes kept; torch tensors are
  taken as numpy; an uneven group is refused."""
  tr = _one_trace(trace)
  tr.append_datum("tensors", "x", torch.arange(3.0))
  tr.append_datum("tensors", "x", torch.arange(3.0) + 1)
  path = str(tmp_path / f"t{ext}")
  tr.save(path)
  back = trace.Trace.load(path)
  for g in ("rollout0", "tensors"):
    for k, v in tr[g].items():
      assert back[g][k].dtype == v.dtype, (g, k)
      np.testing.assert_array_equal(back[g][k], v)
  np.testing.assert_array_equal(back["tensors"]["x"],
                                [[0, 1, 2], [1, 2, 3]])
  bad = trace.Trace()
  bad.append_datum("g", "a", 1.0)
  bad.append_datums("g", {"a": 2.0, "b": 3.0})
  with pytest.raises(ValueError, match="uneven"):
    bad.save(str(tmp_path / f"bad{ext}"))
  rt = trace.rollout_to_trace({"qpos": torch.zeros(4, 2)})
  assert rt["rollout0"]["qpos"].shape == (4, 2)
  assert "rollout0" in repr(rt)


def test_roboset_schema_matches_jax():
  """append_step over two trials and from_paths: the same groups,
  datasets, shapes and values as the JAX package's RoboSetTrace."""
  rng = np.random.default_rng(6)
  steps = [dict(time=np.float32(t), qpos=rng.normal(0, 1, 3),
                qvel=rng.normal(0, 1, 3), ctrl=rng.uniform(0, 1, 2),
                observations=rng.normal(0, 1, 5), rewards=np.float32(t),
                solved=float(t > 1), done=float(t == 3))
           for t in range(4)]
  paths = [{"obs": [rng.normal(0, 1, 5) for _ in range(3)],
            "reward": rng.normal(0, 1, 3), "solved": [0, 1, 1]}]
  trs = []
  for mod in (roboset, jroboset):
    tr = mod.RoboSetTrace("rs")
    for trial in range(2):
      for s in steps:
        tr.append_step(trial, **s)
    tr.stack()
    trs.append((tr, mod.RoboSetTrace.from_paths(paths)))
  for ours, theirs in zip(*trs):
    assert list(ours.keys()) == list(theirs.keys())
    for g in theirs.keys():
      assert list(ours[g]) == list(theirs[g])
      for k, v in theirs[g].items():
        np.testing.assert_array_equal(ours[g][k], np.asarray(v))
  assert roboset.RoboSetTrace.DATA_KEYS == jroboset.RoboSetTrace.DATA_KEYS
  assert roboset.RoboSetTrace.INFO_KEYS == jroboset.RoboSetTrace.INFO_KEYS


def test_playback_of_a_port_trace(tmp_path):
  """A 6-step port rollout of the finger reach (fixed targets) saved as
  .mtp; examine_logs.playback settles its 6 steps as one batch and
  recomputes each step's rewards as 6 batch-1 settles with the reset's
  info do (within 1e-6 of max(1, |reward|)); the CLI prints the
  structure and the reward sum."""
  env = myosuite_tpu_torch.make(FINGER, device="cpu")
  state = env.reset(torch.Generator().manual_seed(0), 1)
  gen = torch.Generator().manual_seed(1)
  rec = {"qpos": [], "qvel": []}
  for _ in range(6):
    state = env.step(state, torch.rand(1, env.action_size, generator=gen))
    rec["qpos"].append(state.data.qpos[0])
    rec["qvel"].append(state.data.qvel[0])
  tr = trace.rollout_to_trace({k: torch.stack(v) for k, v in rec.items()})
  path = str(tmp_path / "finger.mtp")
  tr.save(path)
  got = examine_logs.playback(env, trace.Trace.load(path), "rollout0")
  info = env.reset(torch.Generator().manual_seed(0), 1).info
  assert len(got) == 6
  for t, g in enumerate(got):
    d = robot.sensor2sim(env.model, pio.make_data(env.model, 1), {
        "qpos": rec["qpos"][t][None], "qvel": rec["qvel"][t][None]})
    want = {k: float(v) for k, v in env._get_rewards(d, info).items()}
    assert sorted(g) == sorted(want)
    for k, w in want.items():
      assert abs(g[k] - w) <= 1e-6 * max(1.0, abs(w)), (t, k, g[k], w)
  out = io.StringIO()
  with redirect_stdout(out):
    examine_logs.main(["-t", path, "-e", FINGER, "--mode", "playback",
                       "--device", "cpu"])
  assert "rollout0: 6 steps, recomputed reward sum" in out.getvalue()
  with pytest.raises(SystemExit):     # rendering needs --env_name
    examine_logs.main(["-t", path, "--video", "x.mp4"])


# -- examine_env -------------------------------------------------------------

def _jax_success(solved, done, monkeypatch):
  """The JAX CLI's success rate, its own loop fed supplied per-step
  solved and done flags (T, N) through a stand-in env."""
  t_max, n = solved.shape
  clock = {"t": 0, "ep": -1}

  def reset(rng):
    clock["t"], clock["ep"] = 0, clock["ep"] + 1
    return types.SimpleNamespace(obs={"state": jnp.zeros(1)})

  def step(state, act):
    t, ep = clock["t"], clock["ep"]
    clock["t"] += 1
    return types.SimpleNamespace(
        obs={"state": jnp.zeros(1)}, reward=jnp.float32(1.0),
        metrics={"solved": jnp.float32(solved[t, ep])},
        done=jnp.float32(done[t, ep]), data=None)

  env = types.SimpleNamespace(reset=reset, step=step)
  with monkeypatch.context() as mp:
    mp.setattr(jax, "jit", lambda f, **kw: f)
    paths, rate = jexamine_env.rollout_episodes(env, lambda o, r: 0.0, n,
                                                t_max)
  return rate, [len(p["reward"]) for p in paths]


def test_examine_env_success_rule_matches_jax(monkeypatch):
  """Episode lengths (to the first done) and success (more than 5 solved
  steps within them) on supplied sequences, against the JAX CLI's loop:
  solved after a done, a done at the last step, exactly 5 and 6."""
  t_max, n = 12, 7
  solved = np.zeros((t_max, n), np.float32)
  done = np.zeros((t_max, n), np.float32)
  solved[:, 0] = 1                           # never done: 12 solved
  solved[:5, 1] = 1                          # exactly 5
  solved[:6, 2] = 1                          # 6
  solved[:, 3], done[3, 3] = 1, 1            # done at step 3: 4 counted
  solved[2:, 4], done[8, 4] = 1, 1           # 7 solved before its done
  done[11, 5], solved[5:, 5] = 1, 1          # done at the last step
  solved[6:, 6], done[5, 6], done[9, 6] = 1, 1, 1   # solved after the done
  rate, lengths = _jax_success(solved, done, monkeypatch)
  got = examine_env.successes(torch.from_numpy(solved),
                              torch.from_numpy(done))
  assert examine_env.episode_lengths(torch.from_numpy(done)).tolist() == \
      lengths
  assert float(got.float().mean()) == pytest.approx(rate)
  assert got.tolist() == [True, False, True, False, True, True, False]


def test_examine_env_cli_on_the_cpu(tmp_path, monkeypatch):
  """examine_env --device cpu -n 4 --horizon 10 on the elbow: the summary
  line, and a trace of 4 episodes read back from its .mtp file;
  --render onscreen without a display says the viewer is unavailable and
  runs headless on the device, as the JAX CLI does."""
  path = str(tmp_path / "episodes.mtp")
  out = io.StringIO()
  with redirect_stdout(out):
    examine_env.main(["-e", "MtxElbowPoseRandom-v0", "-n", "4",
                      "--horizon", "10", "--device", "cpu", "--trace", path])
  first = out.getvalue().splitlines()[0]
  assert first.startswith("episodes: 4  success%: ")
  back = trace.Trace.load(path)
  assert sorted(back.keys()) == [f"rollout{i}" for i in range(4)]
  assert back["rollout0"]["observations"].shape[1:] == (9,)
  monkeypatch.delenv("DISPLAY", raising=False)
  out = io.StringIO()
  with redirect_stdout(out):
    examine_env.main(["-e", "MtxElbowPoseRandom-v0", "-n", "2", "--horizon",
                      "3", "--render", "onscreen", "--device", "cpu"])
  lines = out.getvalue().splitlines()
  assert lines[0].startswith("onscreen viewer unavailable (no DISPLAY")
  assert lines[0].endswith("running headless")
  assert lines[1].startswith("episodes: 2  success%: ")

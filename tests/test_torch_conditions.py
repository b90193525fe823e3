"""Muscle conditions, variant ids and the rest of myobase / myoedits in the
port, against the JAX package.

The 3CC-r fatigue update, its initial state (fed the same uniforms) and
params, the sarcopenia fields, the reafferentation mapping, the ASL
targets, and the obs / rewards / done / solved of the torso, arm reach and
arm pose envs on supplied states are held against the JAX functions with
no physics step compiled. Nested overrides, `register_env_variant`, the
auto-reset of nested info and the registry (ids, aliases, suites) are
checked against the JAX registry. The golden file (myosuite_tpu_torch/
assets/myobase_golden.npz) holds 3 control steps of seven envs, stepped by
the JAX package at batch 2; tier-1 replays it through the port, and
`chip_smoke.py` replays it on the card. Regenerate it and the three model
files with

  JAX_PLATFORMS=cpu python -m tests.test_torch_conditions
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
from myosuite_tpu.envs import fatigue as jax_fatigue
from myosuite_tpu.envs import registry as jax_registry
from myosuite_tpu.envs.base import State as JaxState
from myosuite_tpu.physics import io as jax_io
from myosuite_tpu_torch.envs import base, fatigue, registry
from myosuite_tpu_torch.envs.base import State
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from myosuite_tpu_torch.physics import io as tio
from tests.test_torch_io import _assert_committed_matches_fresh_export
from tests.torch_common import EXPORTS, assert_close

ATOL = 1e-5
HAND = "MtxHandReachRandom-v0"
# The JAX registry's ids as the package defines them, taken when the test
# modules are collected: a test of the JAX package
# (tests/test_new_components.py::test_register_env_variant) registers a
# variant into it for good, and may run before test_registry_matches_jax
# in the same process.
JAX_IDS = frozenset(jax_registry.registered_envs())
# the new models' ids, by the model file that holds each
NEW_IDS = {"torso": "MtxTorsoPoseRandom-v0",
           "armreach": "MtxArmReachRandom-v0",
           "armpose": "MtxArmPoseRandom-v0"}
# the 28 bases the JAX package registers with Fati / Sarc variants that the
# port has, and the port's other base ids
VARIANT_BASES = (
    [f"Mtx{s}{k}-v0" for s in ("ElbowPose", "FingerPose", "FingerReach",
                                "HandPose", "HandReach", "HandObjHold",
                                "HandPenTwirl", "HandKeyTurn", "TorsoPose",
                                "ArmReach") for k in ("Random", "Fixed")]
    + ["MtxHandDieReorient-v0", "MtxHandBaoding-v0", "MtxLegWalk-v0",
       "MtxLegStand-v0", "MtxLegWalkRough-v0", "MtxLegWalkHilly-v0",
       "MtxLegWalkStairs-v0", "MtxArmPoseRandom-v0"])
OTHER_BASES = ([f"MtxHandPose{k}Fixed-v0" for k in range(10)]
               + ["MtxReafHandPoseRandom-v0"])


def _jax_make(name, overrides=None):
  """A fresh JAX env: the JAX `make` caches by overrides, which must be
  hashable, so a nested override goes to the factory itself."""
  return jax_registry._REGISTRY[jax_registry.resolve(name)](overrides)


def _port_ids():
  return set(VARIANT_BASES) | set(OTHER_BASES) | {
      f"Mtx{tag}{b[3:]}" for b in VARIANT_BASES for tag in ("Fati", "Sarc")}


# ---------------------------------------------------------------------------
# fatigue
# ---------------------------------------------------------------------------


def _params():
  jenv = myosuite_tpu.make(HAND)
  env = registry.make(HAND, device="cpu")
  jp, jmask = jax_fatigue.make_params(jenv.model, jenv.dt)
  tp, tmask = fatigue.make_params(env.model, env.dt)
  return jp, jmask, tp, tmask


def _fatigue_inputs(rng, batch, n):
  """MA / MR / MF partitions and targets that reach every branch of the
  update: MA below the target with MR above or below the gap, MA at or
  above it, and rates past the clip."""
  ma = rng.uniform(0, 1, (batch, n))
  mf = rng.uniform(0, 1, (batch, n)) * (1 - ma)
  mf[::3] *= 0.02                       # fresh units: MR large
  mf[1::3] = 1 - ma[1::3] - 1e-3        # exhausted: MR ~ 0
  tl = rng.uniform(0, 1, (batch, n))
  tl[:, ::5] = ma[:, ::5]               # MA == TL
  f32 = lambda x: x.astype(np.float32)
  return f32(ma), f32(1 - ma - mf), f32(mf), f32(tl)


def test_make_params_match_jax():
  jp, jmask, tp, tmask = _params()
  np.testing.assert_array_equal(tmask, jmask)
  assert tmask.sum() == 39
  for k in ("tau_act", "tau_deact"):
    np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                  np.asarray(getattr(jp, k)))
  for k in ("F", "R", "r", "dt"):
    assert float(getattr(tp, k)) == float(getattr(jp, k)), k
    assert getattr(tp, k).dtype == torch.float32


def test_compute_act_matches_jax():
  """One update within 1e-6 on inputs that reach every branch (each
  asserted to occur, the clip included); 50 chained updates within
  1e-5."""
  jp, _, tp, _ = _params()
  rng = np.random.default_rng(0)
  ma, mr, mf, tl = _fatigue_inputs(rng, 12, 39)
  # the branches, as the update takes them
  up = ma < tl
  assert (up & (mr > tl - ma)).any() and (up & (mr <= tl - ma)).any()
  assert (ma >= tl).any() and (ma == tl).any()
  dt, F = float(jp.dt), float(jp.F)
  ld = (0.5 + 1.5 * ma) / np.asarray(jp.tau_act)
  c = np.where(up & (mr > tl - ma), ld * (tl - ma), ld * mr)
  c = np.where(ma >= tl, (0.5 + 1.5 * ma) / np.asarray(jp.tau_deact)
               * (tl - ma), c)
  c_max = np.minimum((1 - ma) / dt + F * ma, mr / dt)
  assert (c > c_max).any()                       # the clip binds
  jstep = jax.jit(jax_fatigue.compute_act)
  state = {"MA": ma, "MR": mr, "MF": mf}
  want = jstep(jp, jnp.asarray(tl), {k: jnp.asarray(v)
                                     for k, v in state.items()})
  got = fatigue.compute_act(tp, torch.from_numpy(tl),
                            {k: torch.from_numpy(v) for k, v in state.items()})
  for k in ("MA", "MR", "MF"):
    assert_close(f"compute_act {k}", got[k], want[k], atol=1e-6)
  for _ in range(50):
    tl = rng.uniform(0, 1, ma.shape).astype(np.float32)
    want = jstep(jp, jnp.asarray(tl), want)
    got = fatigue.compute_act(tp, torch.from_numpy(tl), got)
  for k in ("MA", "MR", "MF"):
    assert_close(f"compute_act x50 {k}", got[k], want[k], atol=1e-5)
  total = got["MA"] + got["MR"] + got["MF"]
  assert float((total - 1).abs().max()) < 1e-4


def test_init_state_matches_jax(monkeypatch):
  """Rested by default; random from the same two uniform draws."""
  jp, _, tp, _ = _params()
  rested = fatigue.init_state(tp, 3)
  assert torch.equal(rested["MA"], torch.zeros(3, 39))
  assert torch.equal(rested["MR"], torch.ones(3, 39))
  assert torch.equal(rested["MF"], torch.zeros(3, 39))
  u = np.random.default_rng(1).uniform(0, 1, (2, 3, 39)).astype(np.float32)
  draws = iter(torch.from_numpy(u))
  monkeypatch.setattr(torch, "rand", lambda *a, **k: next(draws))
  got = fatigue.init_state(tp, 3, torch.Generator())
  monkeypatch.undo()
  for b in range(3):
    jdraws = iter(u[:, b])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(next(jdraws)))
    want = jax_fatigue.init_state(jp, jax.random.PRNGKey(0))
    monkeypatch.undo()
    for k in ("MA", "MR", "MF"):
      assert_close(f"init_state env {b} {k}", got[k][b], want[k], atol=1e-7)


def test_effort_matches_jax():
  rng = np.random.default_rng(4)
  ma, tl = rng.uniform(0, 1, (2, 5, 39)).astype(np.float32)
  got = fatigue.effort({"MA": torch.from_numpy(ma)}, torch.from_numpy(tl))
  want = [jax_fatigue.effort({"MA": jnp.asarray(m)}, jnp.asarray(t))
          for m, t in zip(ma, tl)]
  assert_close("effort", got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("in_obs", [False, True])
def test_fatigue_wrapper_step_matches_jax(in_obs, monkeypatch):
  """The controls the wrapper hands to step_ctrl, the fatigue state it
  keeps and the observation it appends, against the JAX wrapper on the
  same fatigue state and actions."""
  jw = jax_fatigue.FatigueWrapper(myosuite_tpu.make(HAND),
                                  fatigue_in_obs=in_obs)
  tw = fatigue.FatigueWrapper(registry.make(HAND, device="cpu"),
                              fatigue_in_obs=in_obs)
  rng = np.random.default_rng(5)
  ma, mr, mf, _ = _fatigue_inputs(rng, 4, 39)
  action = rng.uniform(-0.5, 1.5, (4, 39)).astype(np.float32)
  obs = rng.normal(size=(4, 7)).astype(np.float32)
  # step_ctrl leaves its controls in the observation
  monkeypatch.setattr(jw._env, "step_ctrl",
                      lambda s, c: s.replace(obs={"state": c}))
  monkeypatch.setattr(tw._env, "step_ctrl",
                      lambda s, c: s.replace(obs={"state": c}))

  def jstep(fat, a):
    s = JaxState(None, {}, jnp.float32(0), jnp.float32(0), {},
                 {"fatigue": fat})
    out = jw.step(s, a)
    return out.obs["state"], out.info["fatigue"]

  want = jax.vmap(jstep)({"MA": ma, "MR": mr, "MF": mf}, action)
  state = State(None, {"state": torch.from_numpy(obs)}, torch.zeros(4),
                torch.zeros(4), {}, {"fatigue": {
                    "MA": torch.from_numpy(ma), "MR": torch.from_numpy(mr),
                    "MF": torch.from_numpy(mf)}})
  before = torch.from_numpy(action.copy())
  a = torch.from_numpy(action)
  out = tw.step(state, a)
  assert torch.equal(a, before)
  assert_close("fatigue wrapper obs / ctrl", out.obs["state"], want[0],
               atol=1e-6)
  for k in ("MA", "MR", "MF"):
    assert_close(f"fatigue wrapper {k}", out.info["fatigue"][k], want[1][k],
                 atol=1e-6)


def test_fatigue_wrapper_forwards_the_env():
  env = registry.make("MtxFatiElbowPoseRandom-v0", device="cpu",
                      overrides={"max_episode_steps": 9})
  assert isinstance(env, fatigue.FatigueWrapper)
  assert env.max_episode_steps == 9 and env.action_size == 6
  assert env.dt == 0.02 and float(env.params.dt) == np.float32(0.02)
  assert env.device.type == "cpu" and env._n_substeps == 10
  state = env.reset(torch.Generator().manual_seed(0), 3)
  assert state.info["fatigue"]["MA"].shape == (3, 6)


# ---------------------------------------------------------------------------
# sarcopenia and reafferentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [HAND, "MtxTorsoPoseRandom-v0",
                                  "MtxArmReachRandom-v0",
                                  "MtxArmPoseRandom-v0"])
def test_sarcopenia_fields_match_jax(name):
  """The Sarc id's gain and bias fields bit-equal to the JAX package's,
  in both branches (force > 0: the hand; force <= 0: all of the torso's
  muscles, 24 of the arm's), and different from the base model's."""
  sarc = "MtxSarc" + name[3:]
  jm = myosuite_tpu.make(sarc).model
  tm = registry.make(sarc, device="cpu").model
  base_m = registry.make(name, device="cpu").model
  gp = base_m.actuator_gainprm.numpy()
  for k in ("actuator_gainprm", "actuator_biasprm"):
    np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                  np.asarray(getattr(jm, k)), err_msg=k)
  got = tm.actuator_gainprm.numpy()
  pos = gp[:, 2] > 0
  np.testing.assert_array_equal(got[pos, 2], gp[pos, 2] * np.float32(0.5))
  np.testing.assert_array_equal(got[~pos, 3], gp[~pos, 3] * np.float32(0.5))
  n_neg = {HAND: 0, "MtxTorsoPoseRandom-v0": 210}.get(name, 24)
  assert int((~pos).sum()) == n_neg
  # the base model is untouched
  np.testing.assert_array_equal(
      gp, np.asarray(myosuite_tpu.make(name).model.actuator_gainprm))


def test_muscle_condition_override_weakens_like_jax():
  """make(..., {"muscle_condition": "sarcopenia", "sarcopenia_weakness":
  w}) weakens as the JAX env does; an unknown condition is ignored."""
  ov = {"muscle_condition": "sarcopenia", "sarcopenia_weakness": 0.25}
  tm = registry.make("MtxElbowPoseFixed-v0", "cpu", ov).model
  jm = myosuite_tpu.make("MtxElbowPoseFixed-v0", ov).model
  np.testing.assert_array_equal(tm.actuator_gainprm.numpy(),
                                np.asarray(jm.actuator_gainprm))
  np.testing.assert_array_equal(tm.actuator_biasprm.numpy(),
                                np.asarray(jm.actuator_biasprm))
  plain = registry.make("MtxElbowPoseFixed-v0", "cpu").model
  assert not torch.equal(tm.actuator_gainprm, plain.actuator_gainprm)
  other = registry.make("MtxElbowPoseFixed-v0", "cpu",
                        {"muscle_condition": "other"}).model
  assert torch.equal(other.actuator_gainprm, plain.actuator_gainprm)


def test_reafferentation_matches_jax(monkeypatch):
  """The wrapped action (EIP's command on EPL, EIP's set to 0) and the
  controls of one Reaf step, against the JAX wrapper; the caller's action
  is not changed, and the step puts those controls in data.ctrl."""
  jw = myosuite_tpu.make("MtxReafHandPoseRandom-v0")
  tw = registry.make("MtxReafHandPoseRandom-v0", device="cpu")
  assert isinstance(tw, base.ReafferentationWrapper)
  assert (tw._src, tw._dst) == (jw._src, jw._dst)
  rng = np.random.default_rng(6)
  action = rng.uniform(0, 1, (3, 39)).astype(np.float32)

  class Capture:
    def step(self, state, a):
      return a

  monkeypatch.setattr(jw, "_env", Capture())
  want = np.stack([np.asarray(jw.step(None, jnp.asarray(a))) for a in action])
  monkeypatch.undo()
  monkeypatch.setattr(jw._env, "step_ctrl", lambda s, c: c)
  want_ctrl = np.stack([np.asarray(jw.step(None, jnp.asarray(a)))
                        for a in action])
  monkeypatch.undo()
  a = torch.from_numpy(action.copy())
  inner = tw._env
  monkeypatch.setattr(tw, "_env", Capture())
  got = tw.step(None, a)
  monkeypatch.setattr(tw, "_env", inner)
  assert torch.equal(a, torch.from_numpy(action))
  np.testing.assert_array_equal(got.numpy(), want)
  assert float(got[0, tw._src]) == 0.0
  assert float(got[0, tw._dst]) == float(action[0, tw._src])
  state = tw.reset(torch.Generator().manual_seed(0), 3)
  out = tw.step(state, a)
  assert_close("reaf ctrl", out.data.ctrl, want_ctrl, atol=1e-7)
  # EIP's muscle gets norm_actions(0) = sigmoid(-2.5), not 0
  assert_close("reaf src ctrl", out.data.ctrl[:, tw._src],
               np.full(3, 1 / (1 + np.exp(2.5))), atol=1e-7)


# ---------------------------------------------------------------------------
# the new envs and their configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(10))
def test_asl_target_matches_jax(k):
  name = f"MtxHandPose{k}Fixed-v0"
  jenv = myosuite_tpu.make(name)
  env = registry.make(f"myoHandPose{k}Fixed-v0", device="cpu")
  want = np.asarray(jenv.config.target_jnt_value)
  assert_close(f"ASL {k}", env.config["target_jnt_value"], want, atol=1e-7)
  target = env._sample_target(torch.Generator(), 2)
  assert_close(f"ASL {k} target", target, np.stack([want] * 2), atol=1e-7)
  assert env.config["fixed_target"] and env.config["pose_thd"] == 1.0


def _config_checks(env, jenv):
  cfg, jcfg = env.config, jenv.config
  for k in ("ctrl_dt", "sim_dt", "max_episode_steps", "far_th",
            "fixed_target", "norm_actions"):
    assert cfg[k] == jcfg[k], k
  if "pose_thd" in jcfg:
    assert cfg["pose_thd"] == jcfg.pose_thd
    assert cfg["reset_type"] == jcfg.reset_type
    for k in ("target_jnt_lo", "target_jnt_hi"):
      np.testing.assert_array_equal(np.asarray(cfg[k], np.float32),
                                    np.asarray(jcfg[k], np.float32), k)
  else:
    np.testing.assert_array_equal(np.asarray(env._tip_sids), jenv._tip_sids)
    for k in ("target_lo", "target_hi"):
      np.testing.assert_array_equal(np.asarray(cfg[k], np.float32),
                                    np.asarray(jcfg[k], np.float32), k)
  assert cfg["reward_weights"] == dict(jcfg.reward_weights)


@pytest.mark.parametrize("name", ["MtxTorsoPoseRandom-v0",
                                  "MtxTorsoPoseFixed-v0",
                                  "MtxArmReachRandom-v0",
                                  "MtxArmReachFixed-v0",
                                  "MtxArmPoseRandom-v0"])
def test_new_env_config_matches_jax(name):
  """Targets, thresholds, episode length and reward weights from the model
  file equal the JAX env's config; the model's sizes equal the JAX
  model's."""
  jenv = myosuite_tpu.make(name)
  env = registry.make(name, device="cpu")
  _config_checks(env, jenv)
  m, jm = env.model, jenv.model
  assert (m.nv, m.nu, m.plan["constraint"].nefc, m.ncon_max) == (
      jm.nv, jm.nu, {"Torso": 18, "ArmRe": 7, "ArmPo": 27}[name[3:8]], 0)


def _pose_supplied(env, batch=6, seed=0):
  m = env.model
  rng = np.random.default_rng(seed)
  lo, hi = (m.jnt_range[:, i].numpy() for i in (0, 1))
  qpos = lo + (hi - lo) * rng.uniform(0, 1, (batch, m.nq))
  # targets near (solved), at the bonus shell, and far (done)
  scale = np.array([0.01, 0.2, 0.3, 0.6, 3.0, 12.0])[:batch, None]
  target = qpos + scale * rng.normal(size=(batch, m.nq)) / np.sqrt(m.nq)
  f32 = lambda x: np.asarray(x, np.float32)
  fields = dict(qpos=f32(qpos), qvel=f32(rng.normal(0, 2, (batch, m.nv))),
                act=f32(rng.uniform(0, 1, (batch, m.na))))
  return fields, {"target_angles": f32(target)}


def _reach_supplied(env, batch=6, seed=0):
  m = env.model
  rng = np.random.default_rng(seed)
  f32 = lambda x: np.asarray(x, np.float32)
  sx = rng.normal(0, 0.3, (batch, m.nsite, 3)) + [0, 0, 1]
  tip = sx[:, np.asarray(env._tip_sids)]
  scale = np.array([0.001, 0.01, 0.02, 0.1, 1.5, 3.0])[:batch, None, None]
  targets = tip + scale * rng.normal(size=tip.shape)
  fields = dict(qpos=f32(rng.normal(0, 0.5, (batch, m.nq))),
                qvel=f32(rng.normal(0, 2, (batch, m.nv))),
                act=f32(rng.uniform(0, 1, (batch, m.na))),
                site_xpos=f32(sx),
                time=f32([0.01, 0.05, 0.5, 0.02, 0.06, 1.0][:batch]))
  return fields, {"targets": f32(targets)}


@pytest.mark.parametrize("tag", list(NEW_IDS))
def test_new_env_signals_match_jax(tag):
  """obs, every reward term, the weighted reward, done and solved of the
  torso, arm reach and arm pose envs against the JAX methods on the same
  supplied states."""
  name = NEW_IDS[tag]
  jenv = myosuite_tpu.make(name)
  env = registry.make(name, device="cpu")
  fields, info = (_reach_supplied if tag == "armreach" else
                  _pose_supplied)(env)
  batch = fields["qpos"].shape[0]

  def jax_signals(fields, info):
    d = jax_io.make_data(jenv.model).replace(**fields)
    rewards = jenv._get_rewards(d, info)
    state = JaxState(d, {}, jnp.float32(0.0), jnp.float32(0.0), {}, info)
    return (jenv._get_obs(d, info)["state"], rewards,
            jenv._sum_rewards(rewards), jenv._get_done(state),
            jenv._get_metrics(state, rewards)["solved"])

  want = jax.jit(jax.vmap(jax_signals))(fields, info)
  d = tio.make_data(env.model, batch, "cpu").replace(
      **{k: torch.from_numpy(v) for k, v in fields.items()})
  tinfo = {k: torch.from_numpy(v) for k, v in info.items()}
  rewards = env._get_rewards(d, tinfo)
  state = State(d, {}, torch.zeros(batch), torch.zeros(batch), {}, tinfo)
  got = (env._get_obs(d, tinfo)["state"], rewards, env._sum_rewards(rewards),
         env._get_done(state), env._get_metrics(state, rewards)["solved"])
  assert_close(f"{tag} obs", got[0], want[0], atol=ATOL)
  assert sorted(got[1]) == sorted(want[1])
  for k in got[1]:
    assert_close(f"{tag} reward {k}", got[1][k], want[1][k], atol=ATOL)
  for label, g, w in zip(("reward", "done", "solved"), got[2:], want[2:]):
    assert_close(f"{tag} {label}", g, w, atol=ATOL)
  # the supplied states reach both sides of the thresholds
  assert 0 < float(got[3].sum()) < batch and 0 < float(got[4].sum()) < batch


# ---------------------------------------------------------------------------
# overrides, variants, the auto-reset of nested info, the registry
# ---------------------------------------------------------------------------


def test_nested_override_merges_like_jax():
  """{"reward_weights": {"bonus": 2.0}} updates that one weight, as
  ConfigDict.update does, and the reward follows it."""
  ov = {"reward_weights": {"bonus": 2.0}, "max_episode_steps": 7}
  env = registry.make("MtxElbowPoseRandom-v0", "cpu", ov)
  jenv = _jax_make("MtxElbowPoseRandom-v0", ov)
  assert env.config["reward_weights"] == dict(jenv.config.reward_weights) \
      == {"act_reg": 1.0, "bonus": 2.0, "penalty": 50.0, "pose": 1.0}
  assert env.max_episode_steps == jenv.max_episode_steps == 7
  rewards = {"pose": 0.5, "act_reg": -0.25, "bonus": 1.0, "penalty": -1.0}
  got = env._sum_rewards({k: torch.tensor(v) for k, v in rewards.items()})
  want = jenv._sum_rewards({k: jnp.float32(v) for k, v in rewards.items()})
  assert float(got) == float(want) == -47.75
  # the registry's own defaults are untouched
  assert registry.make("MtxElbowPoseRandom-v0", "cpu").config[
      "reward_weights"]["bonus"] == 4.0


def test_stand_config_and_reward_match_jax():
  """MtxLegStand-v0: the walk config updated by the stand's, all ten
  weights as in the JAX config; the weighted reward of the four terms the
  stand returns equals the JAX env's."""
  env = registry.make("MtxLegStand-v0", "cpu")
  jenv = myosuite_tpu.make("MtxLegStand-v0")
  assert env.config["reward_weights"] == dict(jenv.config.reward_weights)
  assert len(env.config["reward_weights"]) == 10
  assert env.max_episode_steps == 300 and env.config["reset_type"] == "none"
  rng = np.random.default_rng(7)
  terms = {k: rng.normal(size=4).astype(np.float32)
           for k in ("reach", "bonus", "penalty", "act_reg")}
  got = env._sum_rewards({k: torch.from_numpy(v) for k, v in terms.items()})
  want = jenv._sum_rewards({k: jnp.asarray(v) for k, v in terms.items()})
  assert_close("stand reward", got, want, atol=1e-6)


def test_register_env_variant_matches_jax(monkeypatch):
  """A variant made from dot-path keys has the JAX variant's config, id
  and suite; a later override merges into it."""
  for mod in (registry, jax_registry):
    for table in ("_REGISTRY", "_ALIASES", "_SUITES"):
      monkeypatch.setattr(mod, table, dict(getattr(mod, table)))
  variants = {"reward_weights.pose": 2.0, "max_episode_steps": 7}
  vid = registry.register_env_variant("myoFingerPoseRandom-v0", variants,
                                      silent=True)
  jvid = jax_registry.register_env_variant("myoFingerPoseRandom-v0",
                                           variants, silent=True)
  assert vid == jvid == "MtxFingerPoseRandom_max_episode_steps=7-pose=2.0-v0"
  assert registry.suite_of(vid) == jax_registry.suite_of(jvid) == "myobase"
  for ov in (None, {"reward_weights": {"bonus": 1.5}}):
    env = registry.make(vid, "cpu", ov)
    jenv = _jax_make(jvid, ov)
    assert env.config["reward_weights"] == dict(jenv.config.reward_weights)
    assert env.max_episode_steps == jenv.max_episode_steps == 7
  assert env.config["reward_weights"]["pose"] == 2.0
  assert env.config["reward_weights"]["bonus"] == 1.5


def test_autoreset_resets_nested_info(monkeypatch):
  """The fatigue state (a dict in info) of envs 1 and 3, done, comes back
  rested; envs 0 and 2 keep their stepped state."""
  env = registry.make("MtxFatiElbowPoseRandom-v0", device="cpu")
  done = torch.tensor([0.0, 1.0, 0.0, 1.0])
  monkeypatch.setattr(env._env, "_get_done", lambda state: done)
  wrapped = AutoResetWrapper(env)
  state = wrapped.reset(torch.Generator().manual_seed(0), 4)
  action = torch.ones(4, env.action_size)
  stepped = env.step(state, action)
  out = wrapped.step(state, action)
  keep, took = [0, 2], [1, 3]
  for k, rested in (("MA", 0.0), ("MR", 1.0), ("MF", 0.0)):
    assert torch.equal(out.info["fatigue"][k][keep],
                       stepped.info["fatigue"][k][keep]), k
    assert torch.equal(out.info["fatigue"][k][took],
                       torch.full((2, env.action_size), rested)), k
  assert float(stepped.info["fatigue"]["MA"][took].min()) > 0


def test_registry_matches_jax():
  """The port's 308 ids are the JAX registry's, all of them: the ported
  bases, the Fati / Sarc variants of all 32 variant bases (no variant base
  is missing), the SAR and MyoDM ids and the 7 MyoChallenge (suite
  "myochal") ids, which have no variants, each with JAX's aliases and
  suite."""
  from myosuite_tpu_torch.envs import myodm
  ours = set(registry.registered_envs())
  new_bases = ["MtxElbowPoseExoRandom-v0", "MtxElbowPoseExoFixed-v0",
               "MtxFingerTrackCyclic-v0", "MtxHandTrackCyclic-v0"]
  sar = {f"MtxHand{r}-v0" for r in ("Reorient8", "Reorient100",
                                    "ReorientID", "ReorientOOD")}
  dm = ({f"MtxHand{s}-v0" for s, _, _ in myodm.TRACK_SPECS}
        | {f"MtxHand{o.title()}{k}-v0" for o in myodm.GRAB_OBJECTS
           for k in ("Fixed", "Random")})
  chal = {"MtxChaseTag-v0", "MtxChaseTagEvade-v0", "MtxSoccer-v0",
          "MtxRunTrack-v0", "MtxRelocate-v0", "MtxBimanual-v0",
          "MtxTableTennis-v0"}
  bases = VARIANT_BASES + new_bases
  want = (set(bases) | set(OTHER_BASES) | sar | dm | chal
          | {f"Mtx{tag}{b[3:]}" for b in bases for tag in ("Fati", "Sarc")})
  assert ours == want and len(ours) == 308 and len(dm) == 190
  assert _port_ids() <= ours
  theirs = set(JAX_IDS)
  assert ours == theirs and len(theirs) == 308
  assert {n for n in theirs if jax_registry.suite_of(n) == "myochal"} == \
      chal
  for tag in ("Fati", "Sarc"):
    variants = {n for n in theirs if n.startswith("Mtx" + tag)}
    assert variants <= ours
    assert {"Mtx" + n[3 + len(tag):] for n in variants} == set(bases)
  for name in ours:
    assert registry.suite_of(name) == jax_registry.suite_of(name), name
  assert registry.suite_of("myoArmReachRandom-v0") == "myoedits"
  assert registry.suite_of("MyoHandAppleLift-v0") == "myodm"
  assert registry.suite_of("myoChallengeOslRunFixed-v0") == "myochal"
  assert registry._ALIASES == jax_registry._ALIASES


@pytest.mark.parametrize("name", ["myotorso.npz", "myoarm_reach.npz",
                                  "myoarm.npz"])
def test_committed_myobase_npz_matches_fresh_export(name):
  _assert_committed_matches_fresh_export(name)


def test_hand_npz_names_match_mujoco():
  """The hand's model file names its joints and actuators, and the
  reafferentation indices are MuJoCo's."""
  with np.load(os.path.join(registry.ASSETS, "myohand_reach.npz")) as z:
    jnt, act = list(z["jnt_names"]), list(z["actuator_names"])
  assert len(jnt) == 23 and len(act) == 39
  jw = myosuite_tpu.make("MtxReafHandPoseRandom-v0")
  assert (act.index("IF_EIP"), act.index("TH_EPL")) == (jw._src, jw._dst)
  assert jnt[0] == "wrist_flex"


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------

GOLDEN = os.path.join(registry.ASSETS, "myobase_golden.npz")
GOLDEN_BATCH, GOLDEN_STEPS = 2, 3
# tag -> (id, overrides, supplied target): the pose envs start at qpos0
# (reset_type "none"); a Random pose id takes the midpoint of its target
# range as a supplied target
_NONE = {"reset_type": "none"}
GOLDEN_ENVS = {
    "torso": ("MtxTorsoPoseFixed-v0", _NONE, False),
    "armreach": ("MtxArmReachFixed-v0", None, False),
    "armpose": ("MtxArmPoseRandom-v0", _NONE, True),
    "asl": ("MtxHandPose3Fixed-v0", _NONE, False),
    "sarc": ("MtxSarcHandReachFixed-v0", None, False),
    "reaf": ("MtxReafHandPoseRandom-v0", _NONE, True),
    "fati": ("MtxFatiHandReachFixed-v0", None, False),
}
GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")
FATIGUE_FIELDS = ("MA", "MR", "MF")


def golden_fields(tag):
  return GOLDEN_FIELDS + (FATIGUE_FIELDS if tag == "fati" else ())


def golden_target(env):
  """The supplied target of a Random pose id: its range's midpoint."""
  cfg = env.config
  return 0.5 * (np.asarray(cfg["target_jnt_lo"], np.float32)
                + np.asarray(cfg["target_jnt_hi"], np.float32))


def golden_actions(tag, nu):
  rng = np.random.default_rng(2026 + list(GOLDEN_ENVS).index(tag))
  return rng.uniform(0, 1, (GOLDEN_STEPS, GOLDEN_BATCH, nu)).astype(
      np.float32)


def _record(rec, state, fields):
  d = state.data
  vals = dict(obs=state.obs["state"], reward=state.reward, done=state.done,
              qpos=d.qpos, qvel=d.qvel, act=d.act)
  if "MA" in fields:
    vals.update(state.info["fatigue"])
  for k in fields:
    v = vals[k]
    rec[k].append(np.asarray(v.cpu() if hasattr(v, "cpu") else v))


# the models whose JAX step is run op by op: compiling it takes tens of GB
# on a CPU (the torso's 210 muscles on 420 wrap objects)
EAGER = ("torso", "armreach", "armpose")


def jax_golden(tags=tuple(GOLDEN_ENVS)):
  """Each env of GOLDEN_ENVS (of `tags`) in the JAX package: batch 2, 3
  control steps of numpy actions; obs, reward, done, qpos, qvel and act
  (and the fatigue state) after each step."""
  out = {}
  for tag in tags:
    name, overrides, target = GOLDEN_ENVS[tag]
    env = myosuite_tpu.make(name, overrides)
    with jax.disable_jit(tag in EAGER):
      keys = jax.random.split(jax.random.PRNGKey(0), GOLDEN_BATCH)
      state = jax.vmap(env.reset)(keys)
      if target:
        t = np.tile(golden_target(env), (GOLDEN_BATCH, 1))
        state = state.replace(info={**state.info,
                                    "target_angles": jnp.asarray(t)})
      step = jax.jit(jax.vmap(env.step))
      out[f"{tag}_actions"] = golden_actions(tag, env.action_size)
      rec = {k: [] for k in golden_fields(tag)}
      for a in out[f"{tag}_actions"]:
        state = step(state, jnp.asarray(a))
        _record(rec, state, golden_fields(tag))
    out.update({f"{tag}_{k}": np.stack(v) for k, v in rec.items()})
  return out


def port_replay(golden, device, tag):
  """The golden actions through the port's env of `tag` on `device`;
  returns the fields (numpy)."""
  name, overrides, target = GOLDEN_ENVS[tag]
  env = registry.make(name, device=device, overrides=overrides)
  state = env.reset(torch.Generator(device).manual_seed(0), GOLDEN_BATCH)
  if target:
    t = torch.from_numpy(golden_target(env)).to(device)
    state = state.replace(info={**state.info, "target_angles":
                                t.expand(GOLDEN_BATCH, -1).clone()})
  rec = {k: [] for k in golden_fields(tag)}
  for a in golden[f"{tag}_actions"]:
    state = env.step(state, torch.from_numpy(a).to(device))
    _record(rec, state, golden_fields(tag))
  return {k: np.stack(v) for k, v in rec.items()}


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("tag", list(GOLDEN_ENVS))
def test_port_replays_myobase_golden(tag):
  """The committed JAX trajectory, replayed through the port on the CPU,
  within the tolerances stored beside it (chip_smoke.py uses them too)."""
  golden = _golden()
  ours = port_replay(golden, "cpu", tag)
  for k in golden_fields(tag):
    assert_close(f"{tag} {k}", ours[k], golden[f"{tag}_{k}"],
                 atol=float(golden[f"atol_{tag}_{k}"]))


@pytest.mark.slow
def test_myobase_golden_in_sync_with_jax():
  """The JAX package still produces the committed trajectories (the
  torso's and the arms' steps op by op: minutes on a CPU, hence slow)."""
  golden = _golden()
  for k, v in jax_golden().items():
    np.testing.assert_allclose(golden[k], v, rtol=1e-6, atol=1e-6,
                               err_msg=k)


def write_golden(golden=None):
  """Write the golden file: the JAX trajectories (`golden`, or
  `jax_golden()`) plus, per env and field, the tolerance the port is held
  to: 10x the largest gap measured between the port (CPU) and the JAX
  package, and at least 1e-4 of the field's scale."""
  golden = jax_golden() if golden is None else golden
  tols = {}
  for tag in GOLDEN_ENVS:
    ours = port_replay(golden, "cpu", tag)
    for k in golden_fields(tag):
      ref = golden[f"{tag}_{k}"]
      gap = float(np.abs(ours[k] - ref).max())
      scale = float(np.abs(ref).max())
      tol = max(10 * gap, 1e-4 * max(scale, 1.0))
      tols[f"atol_{tag}_{k}"] = np.float64(tol)
      print(f"{tag} {k}: max gap {gap:.3e}, scale {scale:.3e}, "
            f"tolerance {tol:.3e}")
  np.savez(GOLDEN, **golden, **tols)
  print("wrote", GOLDEN)


def write_myobase_npz():
  for name in ("myohand_reach.npz", "myotorso.npz", "myoarm_reach.npz",
               "myoarm.npz"):
    fields, extra = EXPORTS[name]()
    path = os.path.join(registry.ASSETS, name)
    tio.save_model(path, fields, **extra)
    print("wrote", path)


if __name__ == "__main__":
  write_myobase_npz()
  write_golden()

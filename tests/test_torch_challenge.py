"""The port's MyoChallenge envs against the JAX package.

The scripted opponents (colored noise, the ChaseTag opponent, the Soccer
keeper), the OSL controller and the ChaseTag arena are held against the
JAX functions on the same draws and supplied states; each env's obs,
rewards, done and metrics against the JAX methods on supplied `Data`
states (the JAX env's own after a reset and three control steps, some
edited across the task's thresholds), every contact mask slot for slot,
Relocate's per-env model, the auto-reset of an opponent's and a keeper's
state, the registry's ids and the committed model files on the CPU. The
golden file (myosuite_tpu_torch/assets/challenge_golden.npz) holds 3
control steps of each of the 7 ids stepped by the JAX package at batch 2,
the reset they start from (physics, arena, opponent, keeper, object
scales, goals) and the JAX state after the last step; tier-1 replays it
through the port with no JAX rollout compiled, and `chip_smoke.py`
replays it on the card. Regenerate it and the six model files with

  JAX_PLATFORMS=cpu python -m tests.test_torch_challenge

(the JAX side runs one env per process: ~1.5 min per leg env, ~13 min
per arm env, which runs op by op).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
from myosuite_tpu.envs import heightfields as jhf
from myosuite_tpu.envs import opponents as jopp
from myosuite_tpu.envs import osl as josl
from myosuite_tpu.envs.base import State as JaxState
from myosuite_tpu.physics import io as jax_io
from myosuite_tpu_torch.envs import challenge, heightfields, opponents, osl
from myosuite_tpu_torch.envs import registry
from myosuite_tpu_torch.envs.base import State
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from myosuite_tpu_torch.physics import io as tio
from tests.test_torch_io import _assert_committed_matches_fresh_export
from tests.torch_common import CHALLENGE_IDS, EXPORTS, assert_close

GOLDEN = os.path.join(registry.ASSETS, "challenge_golden.npz")
GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")
GOLDEN_BATCH, GOLDEN_STEPS = 2, 3
# tag -> id
IDS = {"chasetag": "MtxChaseTag-v0", "evade": "MtxChaseTagEvade-v0",
       "soccer": "MtxSoccer-v0", "runtrack": "MtxRunTrack-v0",
       "relocate": "MtxRelocate-v0", "bimanual": "MtxBimanual-v0",
       "tabletennis": "MtxTableTennis-v0"}
# the task info entries of each env, as drawn at a reset
INFO_KEYS = {"chasetag": ("opponent",), "evade": ("opponent",),
             "soccer": ("keeper", "scored"), "runtrack": ("osl_phase",),
             "relocate": ("obj_scale", "obj_mass_scale",
                          "obj_friction_scale", "goal_pos"),
             "bimanual": ("goal_pos",), "tabletennis": ("paddle_hit",)}
# the Data fields of the JAX state after the golden's last step that the
# signals read
STATE_FIELDS = ("qpos", "qvel", "act", "time", "xpos", "site_xpos",
                "site_xmat", "cvel", "contact_force", "ten_length",
                "ten_velocity", "actuator_force")
# the arm envs run op by op in the JAX golden: the XLA compile of their
# batched step (the unrolled Newton solve at nv 33-38) did not finish in
# 35 CPU-minutes here, their eager run takes ~13
EAGER = ("relocate", "bimanual", "tabletennis")
ATOL = 1e-5
EXACT = 1e-6   # the opponents, the OSL and the arena, on the same draws


def _t(x, dtype=None):
  return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# opponents
# ---------------------------------------------------------------------------


def _noise_draws(rng, n_steps, n_dim):
  """The normal draws of the JAX package's colored_noise(rng, ...)."""
  r1, r2 = jax.random.split(rng)
  shape = (n_steps // 2 + 1, n_dim)
  return jax.random.normal(r1, shape), jax.random.normal(r2, shape)


@pytest.mark.parametrize("n_steps,n_dim", [(1000, 2), (1000, 1), (37, 2)])
def test_colored_noise_matches_jax(n_steps, n_dim):
  keys = jax.random.split(jax.random.PRNGKey(4), 3)
  re, im = jax.vmap(lambda k: _noise_draws(k, n_steps, n_dim))(keys)
  got = opponents.colored_noise(_t(re), _t(im), n_steps)
  want = jax.jit(jax.vmap(lambda k: jopp.colored_noise(k, n_steps,
                                                      n_dim)))(keys)
  assert got.shape == want.shape
  assert_close(f"colored_noise {n_steps} x {n_dim}", got, want, atol=EXACT)


def _opponent_draws(keys, horizon):
  """The draws of the JAX package's reset_opponent(key, ...) per key."""
  p = jnp.asarray((0.1, 0.45, 0.45), dtype=jnp.float32)

  def draws(key):
    r1, r2, r3, r4 = jax.random.split(key, 4)
    re, im = _noise_draws(r4, horizon, 2)
    return dict(xy=jax.random.uniform(r1, (2,)),
                heading=jax.random.uniform(r2),
                choice=jax.random.categorical(r3, jnp.log(p / p.sum())),
                re=re, im=im)
  return {k: _t(v) for k, v in jax.jit(jax.vmap(draws))(keys).items()}


def _assert_state_close(name, got, want, atol=EXACT):
  for f in dataclasses.fields(want):
    assert_close(f"{name} {f.name}", getattr(got, f.name),
                 getattr(want, f.name), atol=atol)


@pytest.mark.parametrize("mode", [jopp.CHASE, jopp.EVADE])
def test_reset_opponent_from_draws_matches_jax(mode):
  keys = jax.random.split(jax.random.PRNGKey(7), 12)
  got = opponents.opponent_from_draws(_opponent_draws(keys, 40), 40,
                                      arena_half=6.0, mode=mode)
  want = jax.jit(jax.vmap(lambda k: jopp.reset_opponent(k, 40, 6.0,
                                                      mode=mode)))(keys)
  _assert_state_close("reset_opponent", got, want)
  assert got.policy.dtype == torch.int32
  assert set(got.policy.tolist()) == {0, 1, mode}


def _supplied_opponent(rng, batch=16, horizon=12):
  """Opponents of every policy code, at poses near and far from the agent
  and the arena's edge, and noise tables read inside and past their end."""
  pose = rng.uniform(-6.5, 6.5, (batch, 3)).astype(np.float32)
  pose[:, 2] = rng.uniform(-7, 7, batch)
  agent = pose[:, :2] + rng.normal(0, 1.5, (batch, 2)).astype(np.float32)
  agent[::5] = pose[::5, :2]                    # on top of the agent
  return dict(pose=pose, vel=np.zeros((batch, 2), np.float32),
              policy=np.arange(batch, dtype=np.int32) % 4,
              noise=rng.normal(0, 1, (batch, horizon, 2)).astype(np.float32),
              t=rng.integers(0, horizon + 4, batch).astype(np.int32)), agent


def test_step_opponent_matches_jax():
  """Five chained control steps of every policy code."""
  arrays, agent = _supplied_opponent(np.random.default_rng(0))
  got = opponents.OpponentState(**{k: _t(v) for k, v in arrays.items()})
  want = jopp.OpponentState(**{k: jnp.asarray(v) for k, v in arrays.items()})
  step = jax.jit(jax.vmap(lambda o, a: jopp.step_opponent(o, a, 0.02)))
  for i in range(5):
    got = opponents.step_opponent(got, _t(agent), 0.02)
    want = step(want, jnp.asarray(agent))
    _assert_state_close(f"step_opponent {i}", got, want)


def test_keeper_reset_and_step_match_jax():
  """reset_keeper from the JAX draws; then five chained steps of every
  keeper policy, with the ball on and off the goal line's span."""
  keys = jax.random.split(jax.random.PRNGKey(9), 12)
  p = jnp.asarray((0.2, 0.3, 0.5), dtype=jnp.float32)

  def draws(key):
    r1, r2, r3 = jax.random.split(key, 3)
    re, im = _noise_draws(r3, 30, 1)
    return dict(y=jax.random.uniform(r1),
                choice=jax.random.categorical(r2, jnp.log(p / p.sum())),
                re=re, im=im)
  got = opponents.keeper_from_draws(
      {k: _t(v) for k, v in jax.jit(jax.vmap(draws))(keys).items()}, 30)
  want = jax.jit(jax.vmap(lambda k: jopp.reset_keeper(k, 30)))(keys)
  _assert_state_close("reset_keeper", got, want)

  rng = np.random.default_rng(1)
  b = 12
  arrays = dict(pose=rng.uniform(-1.5, 1.5, (b, 2)).astype(np.float32),
                policy=np.arange(b, dtype=np.int32) % 3,
                noise=rng.normal(0, 1, (b, 6, 1)).astype(np.float32),
                t=rng.integers(0, 9, b).astype(np.int32))
  ball = rng.uniform(-2.0, 2.0, (b, 2)).astype(np.float32)
  got = opponents.KeeperState(**{k: _t(v) for k, v in arrays.items()})
  want = jopp.KeeperState(**{k: jnp.asarray(v) for k, v in arrays.items()})
  step = jax.jit(jax.vmap(lambda k, x: jopp.step_keeper(k, x, 0.02, 1.22)))
  for i in range(5):
    got = opponents.step_keeper(got, _t(ball), 0.02, goal_half_width=1.22)
    want = step(want, jnp.asarray(ball))
    _assert_state_close(f"step_keeper {i}", got, want)


# ---------------------------------------------------------------------------
# the OSL controller
# ---------------------------------------------------------------------------


def test_make_osl_params_matches_jax():
  for mass, n_sets in ((None, 4), (75.29745566751475, 4), (60.0, 2)):
    got = osl.make_osl_params(mass, n_sets, device="cpu")
    want = josl.make_osl_params(mass, n_sets)
    assert_close(f"gains {mass}", got.gains, want.gains, atol=0.0)
    assert_close(f"thresh {mass}", got.thresh, want.thresh, atol=0.0)
  rng = np.random.default_rng(2)
  g = rng.uniform(0, 100, (4, 6)).astype(np.float32)
  th = rng.uniform(0, 1, 7).astype(np.float32)
  got = osl.set_osl_param(osl.set_osl_param_batch(
      osl.make_osl_params(device="cpu"), 2, gains=g, thresh=th),
      1, 3, 4, 12.5)
  want = josl.set_osl_param(josl.set_osl_param_batch(
      josl.make_osl_params(), 2, gains=g, thresh=th), 1, 3, 4, 12.5)
  assert_close("set gains", got.gains, want.gains, atol=0.0)
  assert_close("set thresh", got.thresh, want.thresh, atol=0.0)


def _osl_grid(thresh):
  """Every phase at loads, angles and velocities on both sides of each of
  its thresholds, and far enough from the targets to clip the torques."""
  rng = np.random.default_rng(3)
  n = 400
  phase = np.arange(n, dtype=np.int32) % 4
  t = np.asarray(thresh)
  load = rng.choice([0.0, t[2] * 0.5, t[2] * 1.5, t[0] * 1.5, t[5] * 1.5],
                    n).astype(np.float32)
  knee_q = rng.choice([-t[3] * 1.2, -t[3] * 0.8, -t[6] * 0.5, -t[6] * 1.5,
                       -3.0, 2.5], n).astype(np.float32)
  knee_v = rng.choice([-t[4] * 2, t[4] * 2, -0.5, 30.0], n).astype(
      np.float32)
  ankle_q = rng.choice([t[1] * 0.5, t[1] * 1.5, -4.0, 4.0], n).astype(
      np.float32)
  ankle_v = rng.normal(0, 20, n).astype(np.float32)
  return phase, knee_q, knee_v, ankle_q, ankle_v, load


@pytest.mark.parametrize("mass,per_env_mode", [(None, False),
                                                (75.29745566751475, True)])
def test_osl_step_matches_jax(mass, per_env_mode):
  """Every transition and both torque clips, against the JAX controller
  (vmapped over the envs); with per_env_mode, each env picks one of four
  parameter sets, one of them replaced."""
  jparams = josl.make_osl_params(mass)
  tparams = osl.make_osl_params(mass, device="cpu")
  g = np.asarray(jparams.gains[0]) * 1.7
  jparams = josl.set_osl_param_batch(jparams, 3, gains=g)
  tparams = osl.set_osl_param_batch(tparams, 3, gains=g)
  args = _osl_grid(jparams.thresh[0])
  mode = (np.arange(len(args[0]), dtype=np.int32) // 4) % 4
  if per_env_mode:
    want = jax.vmap(lambda *a: josl.osl_step(a[0], jparams, *a[1:6],
                                             mode=a[6]))(*args, mode)
    got = osl.osl_step(_t(args[0]), tparams, *map(_t, args[1:]),
                       mode=_t(mode))
  else:
    want = jax.vmap(lambda *a: josl.osl_step(a[0], jparams, *a[1:]))(*args)
    got = osl.osl_step(_t(args[0]), tparams, *map(_t, args[1:]))
  assert got[0].dtype == torch.int32
  assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
  for phase in range(4):      # every phase is left and kept somewhere
    was = args[0] == phase
    assert (np.asarray(want[0])[was] != phase).any()
    assert (np.asarray(want[0])[was] == phase).any()
  for name, i, peak in (("knee", 1, josl.KNEE_PEAK_TORQUE),
                        ("ankle", 2, josl.ANKLE_PEAK_TORQUE)):
    assert_close(f"osl {name} torque", got[i], want[i], atol=EXACT)
    assert (np.abs(np.asarray(want[i])) == np.float32(peak)).any()


# ---------------------------------------------------------------------------
# the ChaseTag arena
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (13, 11)])
def test_chasetag_arena_matches_jax(shape):
  """The arena from the JAX draws of each of 6 keys: per patch its code
  and its own grid and scalar draws; (13, 11) pads the last row and
  column with edge values."""
  keys = jax.random.split(jax.random.PRNGKey(11), 6)
  ph, pw = shape[0] // 2, shape[1] // 2

  def draws(key):
    rngs = jax.random.split(key, 8)
    return (jnp.stack([jax.random.randint(rngs[2 * k], (), 0, 3)
                       for k in range(4)]),
            jnp.stack([jax.random.uniform(rngs[2 * k + 1], (ph, pw))
                       for k in range(4)]),
            jnp.stack([jax.random.uniform(rngs[2 * k + 1])
                       for k in range(4)]))
  codes, grids, scalars = jax.jit(jax.vmap(draws))(keys)
  got = heightfields.arena_from_draws(_t(codes), _t(grids), _t(scalars),
                                      shape)
  want = jax.jit(jax.vmap(lambda k: jhf.chasetag_arena(k, shape)))(keys)
  assert got.shape == want.shape
  assert set(np.asarray(codes).ravel().tolist()) == {0, 1, 2}
  assert_close(f"chasetag_arena {shape}", got, want, atol=EXACT)


# ---------------------------------------------------------------------------
# the envs
# ---------------------------------------------------------------------------


_JAX_ENVS = {}


def _jax_env(tag):
  if tag not in _JAX_ENVS:
    _JAX_ENVS[tag] = myosuite_tpu.make(IDS[tag])
  return _JAX_ENVS[tag]


def _port_env(tag, device="cpu"):
  return registry.make(IDS[tag], device=device)


def test_contact_masks_match_jax():
  """Every contact mask of every env, slot for slot."""
  pairs = (("chasetag", "_grf_mask_r"), ("chasetag", "_grf_mask_l"),
           ("soccer", "_grf_mask_r"), ("soccer", "_grf_mask_l"),
           ("runtrack", "_grf_mask_r"), ("runtrack", "_grf_mask_l"))
  for tag, attr in pairs:
    got, want = getattr(_port_env(tag), attr), getattr(_jax_env(tag), attr)
    assert np.array_equal(got.numpy(), np.asarray(want)), (tag, attr)
    assert 0 < float(got.sum()) < got.shape[0]
  bim = _port_env("bimanual")._touch_masks
  jbim = np.stack([np.asarray(m) for m in _jax_env("bimanual")._touch_masks],
                  -1)
  assert np.array_equal(bim.numpy(), jbim)
  assert (jbim[:, :4].sum(0) > 0).all()   # myo, pros, start, goal touch
  tt = _port_env("tabletennis")._touch_masks
  jtt = _jax_env("tabletennis")
  assert np.array_equal(tt[:, 0].numpy(), np.asarray(jtt._paddle_ball))
  assert np.array_equal(tt[:, 1].numpy(), np.asarray(jtt._table_ball))
  assert (tt.sum(0) > 0).all()
  assert np.array_equal(_port_env("bimanual")._robotic.numpy(),
                        np.asarray(_jax_env("bimanual")._robotic))


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


def _supplied(tag, golden, env):
  """Numpy Data fields and info of 4 envs: the JAX state after the
  golden's last step (envs 0, 1) and the same two edited across the
  task's thresholds (envs 2, 3)."""
  pre = f"{tag}_final_"
  f = {k[len(pre):]: np.concatenate([v, v]) for k, v in golden.items()
       if k.startswith(pre) and not k.startswith(pre + "info_")}
  ipre = pre + "info_"
  info = {k[len(ipre):]: np.concatenate([v, v]) for k, v in golden.items()
          if k.startswith(ipre)}
  rng = np.random.default_rng(5)
  cf = f["contact_force"]
  cf[2:] = np.where(rng.uniform(0, 1, cf[2:].shape) < 0.5,
                    rng.uniform(0, 300, cf[2:].shape), 0.0)
  if tag in ("chasetag", "evade"):
    info["opponent__pose"][2, :2] = f["qpos"][2, :2] + 0.1   # caught
    f["qpos"][3, 0] = 7.0                                    # out of bounds
    info["step_count"][2] = env.max_episode_steps            # evader wins
  if tag == "soccer":
    info["scored"][2] = 1.0
    f["site_xpos"][3, env._pelvis_site, 2] = 0.5             # fallen
  if tag == "runtrack":
    f["qpos"][2, 0] = 25.0                                   # finished
    f["qvel"][3, 0] = 1.0                                    # running
  if tag == "relocate":
    f["site_xpos"][2, env._obj_site] = info["goal_pos"][2] + 0.01
    f["site_xpos"][3, env._obj_site, 2] = 0.5                # dropped
  if tag == "bimanual":
    f["site_xpos"][2, env._obj_site] = info["goal_pos"][2] + 0.01
    f["site_xpos"][3, env._obj_site, 2] = 0.5
  if tag == "tabletennis":
    info["paddle_hit"][2] = 1.0
    qa, da = env._ball_qadr, env._ball_dadr
    f["qpos"][2, qa:qa + 3] = [-1.5, 0.1, 1.0]               # returned
    f["qvel"][2, da] = -2.0
    f["qpos"][3, qa + 2] = 0.3                               # lost
  return f, info


def _jax_info(info):
  out = {}
  for k, v in info.items():
    entry, _, field = k.partition("__")
    if field:
      out.setdefault(entry, {})[field] = jnp.asarray(v)
    else:
      out[k] = jnp.asarray(v)
  for entry, cls in (("opponent", jopp.OpponentState),
                     ("keeper", jopp.KeeperState)):
    if entry in out:
      out[entry] = cls(**out[entry])
  return out


@pytest.mark.parametrize("tag", list(IDS))
def test_env_signals_match_jax(tag):
  """obs, every reward term, the weighted reward, done and the metrics of
  the port against the JAX methods on the same supplied states."""
  jenv, env = _jax_env(tag), _port_env(tag)
  fields, info = _supplied(tag, _golden(), env)
  batch = fields["qpos"].shape[0]

  def jax_signals(fields, info):
    d = jax_io.make_data(jenv.model).replace(**fields)
    rewards = jenv._get_rewards(d, info)
    state = JaxState(d, {}, jnp.float32(0.0), jnp.float32(0.0), {}, info)
    done = jenv._get_done(state)
    metrics = jenv._get_metrics(state.replace(done=done), rewards)
    return (jenv._get_obs(d, info)["state"], rewards,
            jenv._sum_rewards(rewards), done, metrics)

  want = jax.jit(jax.vmap(jax_signals))(fields, _jax_info(info))
  d = tio.make_data(env.model, batch, "cpu").replace(
      **{k: _t(v) for k, v in fields.items()})
  tinfo = challenge.nested_info({k: _t(v) for k, v in info.items()})
  rewards = env._get_rewards(d, tinfo)
  state = State(d, {}, torch.zeros(batch), torch.zeros(batch), {}, tinfo)
  done = env._get_done(state)
  got = (env._get_obs(d, tinfo)["state"], rewards, env._sum_rewards(rewards),
         done, env._get_metrics(state.replace(done=done), rewards))
  assert_close(f"{tag} obs", got[0], want[0], atol=ATOL)
  assert sorted(got[1]) == sorted(want[1])
  for k in got[1]:
    assert_close(f"{tag} reward {k}", got[1][k], want[1][k], atol=ATOL)
  # the weighted sum: each term's tolerance times its weight (up to 1000)
  wmax = max(abs(w) for w in env.config["reward_weights"].values())
  assert_close(f"{tag} reward", got[2], want[2], atol=ATOL * wmax)
  assert_close(f"{tag} done", got[3], want[3], atol=0.0)
  assert sorted(got[4]) == sorted(want[4])
  for k in got[4]:
    assert_close(f"{tag} metric {k}", got[4][k], want[4][k], atol=ATOL)
  # the edited envs cross the task's thresholds
  assert float(got[3][:2].sum()) == 0.0 and float(got[3][2:].sum()) >= 1.0


def test_relocate_per_env_model_matches_jax():
  """The per-env fields of two envs' draws against JAX's _model_for_step
  of each env's info."""
  jenv, env = _jax_env("relocate"), _port_env("relocate")
  u = torch.tensor([[0.1, 0.9, 0.3, 0.5, 0.5, 0.5],
                    [0.95, 0.05, 0.8, 0.2, 0.7, 0.1]])
  info = env.randomization_from_draws(u)
  got = env._model_for_step(info)
  for i in range(2):
    jm = jenv._model_for_step({k: jnp.asarray(v[i].numpy())
                               for k, v in info.items()})
    for k in ("geom_size", "geom_friction", "body_mass", "body_inertia"):
      assert_close(f"relocate env {i} {k}", got.params[k][i],
                   getattr(jm, k), atol=0.0)
  assert not torch.equal(got.params["body_mass"][0],
                         got.params["body_mass"][1])


def _jax_uniforms(monkeypatch, draws):
  """jax.random.uniform returning the supplied [0, 1) draws, one array per
  call in order, scaled as jax.random.uniform scales its own."""
  seq = iter(draws)

  def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
    u = jnp.asarray(next(seq), dtype).reshape(shape)
    return u * (jnp.asarray(maxval, dtype) - jnp.asarray(minval, dtype)) \
        + jnp.asarray(minval, dtype)
  monkeypatch.setattr(jax.random, "uniform", uniform)


def test_arm_draws_match_jax(monkeypatch):
  """Relocate's randomization, Bimanual's start and goal shifts and
  TableTennis's serve from the same uniforms as the JAX envs."""
  rng = np.random.default_rng(8)
  u = rng.uniform(0, 1, 6).astype(np.float32)
  env = _port_env("relocate")
  _jax_uniforms(monkeypatch, [u[3:6], u[0], u[1], u[2]])
  want = _jax_env("relocate")._sample_randomization(jax.random.PRNGKey(0))
  got = env.randomization_from_draws(_t(u)[None])
  for k, v in want.items():
    assert_close(f"relocate {k}", got[k][0], v, atol=EXACT)

  env = _port_env("bimanual")
  jenv = _jax_env("bimanual")
  s, g = rng.uniform(0, 1, (2, 2)).astype(np.float32)
  _jax_uniforms(monkeypatch, [s, g])
  monkeypatch.setattr(jenv, "_make_data", lambda q, v: q)
  monkeypatch.setattr(jenv, "_get_obs", lambda d, i: {})
  jstate = jenv.reset(jax.random.PRNGKey(0))
  assert_close("bimanual goal", env.goal_from_draws(_t(g)[None])[0],
               jstate.info["goal_pos"], atol=EXACT)
  start = challenge._uniform(_t(s), -0.04, 0.04)
  qa = env._obj_qadr
  assert_close("bimanual start", env.model.qpos0[qa:qa + 2] + start,
               jstate.data[qa:qa + 2], atol=EXACT)

  t = rng.uniform(0, 1, (4, 3)).astype(np.float32)
  pos, vel = challenge.TableTennisEnv.launch_from_draws(_t(t))
  jenv = _jax_env("tabletennis")
  for i in range(4):
    _jax_uniforms(monkeypatch, list(t[i]))
    jpos, jvel = jenv._launch_ball(jax.random.PRNGKey(0))
    assert_close(f"serve pos {i}", pos[i], jpos, atol=EXACT)
    assert_close(f"serve vel {i}", vel[i], jvel, atol=EXACT)


@pytest.mark.parametrize("tag,entry", [("chasetag", "opponent"),
                                       ("soccer", "keeper")])
def test_autoreset_takes_fresh_opponent_where_done(tag, entry, monkeypatch):
  """A batch in which envs 1 and 3 are done: their opponent's (keeper's)
  state comes from the wrapper's fresh reset, every field of it; envs 0
  and 2 keep the stepped one."""
  env = _port_env(tag)
  B = 4
  done = torch.tensor([0.0, 1.0, 0.0, 1.0])
  monkeypatch.setattr(env, "_get_done", lambda state: done)
  wrapped = AutoResetWrapper(env)
  state = wrapped.reset(torch.Generator().manual_seed(0), B)
  action = torch.rand(B, env.action_size,
                      generator=torch.Generator().manual_seed(1))
  copy = torch.Generator()
  copy.set_state(state.info["reset_generator"].get_state())
  stepped = env.step(state, action)
  fresh = env.reset(copy, B)
  out = wrapped.step(state, action)
  keep, took = [0, 2], [1, 3]
  got, new, old = out.info[entry], fresh.info[entry], stepped.info[entry]
  assert type(got) is type(old)
  for f in dataclasses.fields(old):
    g, n, o = (getattr(x, f.name) for x in (got, new, old))
    assert torch.equal(g[keep], o[keep]), f.name
    assert torch.equal(g[took], n[took]), f.name
  assert torch.equal(got.t[took], torch.zeros(2, dtype=torch.int32))
  assert torch.equal(got.t[keep], torch.ones(2, dtype=torch.int32))
  assert not torch.equal(got.noise[took], old.noise[took])
  assert torch.equal(out.data.mocap_pos[took], fresh.data.mocap_pos[took])


_SHAPES = {"chasetag": (20, 80, 80, 54), "evade": (20, 80, 80, 54),
           "soccer": (26, 80, 80, 138), "runtrack": (20, 58, 56, 54),
           "relocate": (33, 63, 63, 235), "bimanual": (38, 68, 68, 336),
           "tabletennis": (33, 63, 63, 39)}
_ALIASES = {"chasetag": ("myoChallengeChaseTagP1-v0",),
            "evade": ("myoChallengeChaseTagP2-v0",),
            "soccer": ("myoChallengeSoccerP1-v0",),
            "runtrack": ("myoChallengeRunTrackP1-v0",
                         "myoChallengeOslRunFixed-v0"),
            "relocate": ("myoChallengeRelocateP1-v0",),
            "bimanual": ("myoChallengeBimanual-v0",),
            "tabletennis": ("myoChallengeTableTennisP1-v0",)}


def test_registry_challenge_ids_and_shapes(monkeypatch):
  """Each id, its aliases and suite, class, (nv, nu, action_size, nefc),
  the role and the config taken from the model file; make needs CUDA
  unless the CPU is named."""
  for tag, name in IDS.items():
    for a in _ALIASES[tag]:
      assert registry.resolve(a) == name
    assert registry.suite_of(name) == "myochal"
    env = registry.make(_ALIASES[tag][0], device="cpu")
    m = env.model
    assert (m.nv, m.nu, env.action_size, m.plan["constraint"].nefc) == \
        _SHAPES[tag], tag
    jcfg = _jax_env(tag).config
    for k, v in env.config.items():
      if k in jcfg and k not in ("reward_weights",):
        assert v == (tuple(jcfg[k]) if isinstance(v, tuple) else jcfg[k]), k
    assert env.config["reward_weights"] == dict(jcfg.reward_weights)
    assert type(env).__name__ == type(_jax_env(tag)).__name__
  assert registry.make("MtxChaseTagEvade-v0", "cpu").config[
      "agent_role"] == "evade"
  with np.load(registry.CHALLENGE_NPZ["runtrack"]) as z:
    assert list(z["actuator_names"][-2:]) == ["osl_knee", "osl_ankle"]
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for name in IDS.values():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      registry.make(name)


@pytest.mark.parametrize("name", list(CHALLENGE_IDS))
def test_committed_challenge_npz_matches_fresh_export(name):
  _assert_committed_matches_fresh_export(name)


_ISOLATION = """
import sys
sys.modules["jax"] = None
sys.modules["mujoco"] = None
import torch
import myosuite_tpu_torch
for name in ("MtxChaseTag-v0", "MtxChaseTagEvade-v0", "MtxSoccer-v0",
             "MtxRunTrack-v0", "MtxRelocate-v0", "MtxBimanual-v0",
             "MtxTableTennis-v0"):
  env = myosuite_tpu_torch.make(name, device="cpu")
  state = env.reset(torch.Generator().manual_seed(0), batch=1)
  assert torch.isfinite(state.obs["state"]).all(), name
bad = [k for k in sys.modules
       if k.split(".")[0] in ("myosuite_tpu", "jax", "flax", "mujoco",
                              "ml_collections")
       and sys.modules[k] is not None]
assert not bad, bad
print("ok")
"""


def test_challenge_models_load_without_jax_or_mujoco():
  """With jax and mujoco unimportable, the port loads the six committed
  models and resets each of the 7 envs, and loads no module of the JAX
  package."""
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=repo,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------


def golden_actions(tag, width):
  rng = np.random.default_rng(2027 + list(IDS).index(tag))
  return rng.uniform(0, 1, (GOLDEN_STEPS, GOLDEN_BATCH, width)).astype(
      np.float32)


def _flat(prefix, info, keys):
  """Info entries as numpy arrays, a state dataclass's fields under
  "<entry>__<field>"."""
  out = {}
  for k in keys:
    v = info[k]
    if dataclasses.is_dataclass(v):
      for f in dataclasses.fields(v):
        out[f"{prefix}{k}__{f.name}"] = np.asarray(getattr(v, f.name))
    else:
      out[prefix + k] = np.asarray(v)
  return out


def jax_golden(tags=tuple(IDS)):
  """Each env in the JAX package: batch 2, 3 control steps of numpy
  actions; the reset (qpos, qvel, arena, task info), obs, reward, done,
  qpos, qvel and act after each step, and the state after the last."""
  out = {}
  for tag in tags:
    env = myosuite_tpu.make(IDS[tag])
    with jax.disable_jit(tag in EAGER):
      out.update(_jax_golden_env(tag, env))
  return out


def _jax_golden_env(tag, env):
  """jax_golden of one env."""
  out = {}
  keys = jax.random.split(jax.random.PRNGKey(0), GOLDEN_BATCH)
  state = jax.jit(jax.vmap(env.reset))(keys)
  d = state.data
  out[f"{tag}_init_qpos"] = np.asarray(d.qpos)
  out[f"{tag}_init_qvel"] = np.asarray(d.qvel)
  if tag in ("chasetag", "evade"):
    out[f"{tag}_init_hfield"] = np.asarray(d.hfield_data)
  out.update(_flat(f"{tag}_init_info_", state.info, INFO_KEYS[tag]))
  out[f"{tag}_actions"] = golden_actions(tag, env.action_size)
  step = jax.jit(jax.vmap(env.step))
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in out[f"{tag}_actions"]:
    state = step(state, jnp.asarray(a))
    for k, v in zip(GOLDEN_FIELDS, (state.obs["state"], state.reward,
                                    state.done, state.data.qpos,
                                    state.data.qvel, state.data.act)):
      rec[k].append(np.asarray(v))
  out.update({f"{tag}_{k}": np.stack(v) for k, v in rec.items()})
  fields = STATE_FIELDS + (("hfield_data",) if tag in ("chasetag", "evade")
                           else ())
  out.update({f"{tag}_final_{k}": np.asarray(getattr(state.data, k))
              for k in fields})
  out.update(_flat(f"{tag}_final_info_", state.info,
                   INFO_KEYS[tag] + ("step_count",)))
  return out


def port_replay(golden, device, tag):
  """The golden's reset and actions through the port's env `tag`;
  returns the fields (numpy)."""
  from myosuite_tpu_torch.envs.challenge import nested_info, state_from
  env = registry.make(IDS[tag], device=device)
  dev = torch.device(device)
  gen = torch.Generator(dev).manual_seed(0)
  state = env.reset(gen, GOLDEN_BATCH)
  at = lambda k: torch.from_numpy(golden[f"{tag}_{k}"]).to(dev)
  pre = f"{tag}_init_info_"
  info = nested_info({k[len(pre):]: torch.from_numpy(v).to(dev)
                      for k, v in golden.items() if k.startswith(pre)})
  state = state_from(env, state, at("init_qpos"), at("init_qvel"), info,
                     at("init_hfield") if f"{tag}_init_hfield" in golden
                     else None)
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in golden[f"{tag}_actions"]:
    state = env.step(state, torch.from_numpy(a).to(dev))
    for k, v in zip(GOLDEN_FIELDS, (state.obs["state"], state.reward,
                                    state.done, state.data.qpos,
                                    state.data.qvel, state.data.act)):
      rec[k].append(v.cpu().numpy())
  return {k: np.stack(v) for k, v in rec.items()}


@pytest.mark.parametrize("tag", list(IDS))
def test_port_replays_challenge_golden(tag):
  """The committed JAX trajectory, replayed through the port on the CPU
  from the JAX reset, within the tolerances stored beside it
  (chip_smoke.py uses them too)."""
  golden = _golden()
  ours = port_replay(golden, "cpu", tag)
  for k in GOLDEN_FIELDS:
    assert_close(f"{tag} {k}", ours[k], golden[f"{tag}_{k}"],
                 atol=float(golden[f"atol_{tag}_{k}"]))


def _jax_golden_by_process(tags=tuple(IDS)):
  """jax_golden of each tag in a process of its own (the JAX compile of
  each env's step stays in its process's memory)."""
  import tempfile
  golden = {}
  with tempfile.TemporaryDirectory() as tmp:
    for tag in tags:
      path = os.path.join(tmp, f"{tag}.npz")
      subprocess.run([sys.executable, "-m", "tests.test_torch_challenge",
                      "--jax-golden", tag, path], check=True)
      with np.load(path) as z:
        golden.update({k: z[k] for k in z.files})
  return golden


@pytest.mark.slow
def test_challenge_golden_in_sync_with_jax():
  """The JAX package still produces the committed trajectories (~1.5 min
  per leg env and ~13 per arm env on a CPU, hence slow)."""
  golden = _golden()
  for k, v in _jax_golden_by_process().items():
    np.testing.assert_allclose(golden[k], v, rtol=1e-6, atol=1e-6,
                               err_msg=k)


def write_golden():
  """Write the golden file: the JAX trajectories plus, per env and field,
  the tolerance the port is held to: 10x the largest gap measured between
  the port (CPU) and the JAX package, and at least 1e-4 of the field's
  scale."""
  golden = _jax_golden_by_process()
  tols = {}
  for tag in IDS:
    ours = port_replay(golden, "cpu", tag)
    for k in GOLDEN_FIELDS:
      ref = golden[f"{tag}_{k}"]
      gap = float(np.abs(ours[k] - ref).max())
      scale = float(np.abs(ref).max())
      tol = max(10 * gap, 1e-4 * max(scale, 1.0))
      tols[f"atol_{tag}_{k}"] = np.float64(tol)
      print(f"{tag} {k}: max gap {gap:.3e}, scale {scale:.3e}, "
            f"tolerance {tol:.3e}")
  np.savez_compressed(GOLDEN, **golden, **tols)
  print("wrote", GOLDEN)


if __name__ == "__main__":
  if sys.argv[1:2] == ["--jax-golden"]:
    np.savez(sys.argv[3], **jax_golden((sys.argv[2],)))
  else:
    from tests.torch_common import write_export
    for name in CHALLENGE_IDS:
      write_export(name)
    write_golden()

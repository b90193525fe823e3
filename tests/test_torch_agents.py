"""The port's agents and env periphery against the JAX package, on the CPU.

obs_vec, the gym adapter, the reflex controller (and its tables in the
leg model files), the sweep launcher, the package's suite lists and the
five pretrained policies: every tensor of the committed checkpoints
against the JAX package's orbax ones, the elbow policy solving its task,
and the closed-loop goldens of the elbow and the stand.

Run as a script to export the pretrained policies from the JAX package's
orbax checkpoints into the port's checkpoints, and to write
myosuite_tpu_torch/assets/pretrained_golden.npz (the JAX package's own
deterministic eval of each policy, 512 episodes, and 10 closed-loop control
steps of the elbow and the stand from the JAX reset; a few minutes of JAX
compile):

  JAX_PLATFORMS=cpu python -m tests.test_torch_agents --export-pretrained
"""

import argparse
import glob
import importlib
import json
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
import myosuite_tpu_torch
from myosuite_tpu.agents import reflex as jreflex
from myosuite_tpu.envs import obs_vec as jobs_vec
from myosuite_tpu.train import checkpoint as jckpt
from myosuite_tpu.train import ppo as jppo
from myosuite_tpu.train import running_stats as jrs
from myosuite_tpu_torch.agents import launcher, pretrained, reflex
from myosuite_tpu_torch.envs import gym_adapter, obs_vec, registry
from myosuite_tpu_torch.train import checkpoint, convert
from myosuite_tpu_torch.train import ppo as ppo_mod
from tests.torch_common import assert_close

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PRETRAINED = os.path.join(_REPO, "myosuite_tpu", "agents", "pretrained")
GOLDEN = os.path.join(registry.ASSETS, "pretrained_golden.npz")
GAIT = os.path.join(pretrained.ROOT, "reflex_gait.json")

# the JAX eval stored in the golden file: episodes and horizon per policy
# (the leg policies' first 100 of their 300 and 1000 control steps)
EVAL_EPISODES, EVAL_HORIZON = 512, 100
# closed-loop goldens: tag -> (env id, batch, control steps)
CLOSED_LOOP = {"elbow": ("MtxElbowPoseRandom-v0", 2, 10),
               "stand": ("MtxLegStand-v0", 2, 10)}
TAGS = {"MtxElbowPoseRandom-v0": "elbow", "MtxFingerPoseRandom-v0": "finger",
        "MtxHandReachRandom-v0": "hand", "MtxLegStand-v0": "stand",
        "MtxLegWalk-v0": "walk"}
FIELDS = pretrained.CLOSED_LOOP_FIELDS


@pytest.fixture(autouse=True)
def one_thread():
  """One intra-op thread: the many small ops of a CPU env step run faster
  alone than on a thread pool shared with the other test workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the exporter: orbax checkpoints -> the port's train_state.pt
# ---------------------------------------------------------------------------

def jax_checkpoint_dir(env_id):
  steps = glob.glob(os.path.join(JAX_PRETRAINED, env_id.replace("-", "_"),
                                 "step_*"))
  return max(steps, key=lambda p: int(p.rsplit("_", 1)[1]))


def jax_learner(env_id):
  """(JAX PPO, its TrainState with the shipped learner restored): the
  target's sizes and learning-rate schedule come from the checkpoint's
  metadata (a cosine schedule keeps a count of its own)."""
  import orbax.checkpoint as ocp
  path = jax_checkpoint_dir(env_id)
  meta = ocp.StandardCheckpointer().metadata(path)
  tree = getattr(meta, "item_metadata", meta)
  tree = getattr(tree, "tree", tree)
  mlp = tree["policy_params"]["params"]["MLP_0"]
  obs_dim = mlp["dense_0"]["kernel"].shape[0]
  act = mlp["out"]["bias"].shape[0] // 2
  cfg = jppo.default_config()
  if tree["opt_state"]["inner_state"][1][1] is not None:
    cfg.lr_schedule = "cosine"
  jp = jppo.PPO(types.SimpleNamespace(action_size=act), cfg)
  k1, k2 = jax.random.split(jax.random.PRNGKey(0))
  dummy = jnp.zeros((1, obs_dim))
  pp, vp = jp.policy.init(k1, dummy), jp.value.init(k2, dummy)
  ts = jppo.TrainState(policy_params=pp, value_params=vp,
                       opt_state=jp.optimizer.init((pp, vp)),
                       obs_stats=jrs.init(obs_dim), env_state=None,
                       rng=jax.random.PRNGKey(0), env_steps=jnp.int32(0))
  return jp, jax.device_get(jckpt.restore_learner(path, ts))


def port_learner(jts):
  """The restored JAX learner as the port's PPO TrainState (no env)."""
  pol = convert.state_dict_from_flax(jts.policy_params)
  val = convert.state_dict_from_flax(jts.value_params)
  return ppo_mod.TrainState(
      policy_params=pol, value_params=val,
      opt_state=convert.opt_state_from_optax(jts.opt_state),
      obs_stats=convert.running_stats_from_flax(jts.obs_stats),
      env_state=None, generator=None, env_steps=int(jts.env_steps))


def export_pretrained(root=pretrained.ROOT, env_ids=pretrained.ENV_IDS):
  """Write each policy's learner-only checkpoint under `root` and copy
  its metrics.jsonl, and summary.json and reflex_gait.json beside them."""
  for env_id in env_ids:
    _, jts = jax_learner(env_id)
    src = jax_checkpoint_dir(env_id)
    step = int(src.rsplit("_", 1)[1])
    sub = env_id.replace("-", "_")
    out = checkpoint.save(os.path.join(root, sub), port_learner(jts),
                          step=step, learner_only=True)
    shutil.copy(os.path.join(os.path.dirname(src), "metrics.jsonl"),
                os.path.join(root, sub, "metrics.jsonl"))
    print("wrote", out)
  for name in ("summary.json", "reflex_gait.json"):
    shutil.copy(os.path.join(JAX_PRETRAINED, name), os.path.join(root, name))


# ---------------------------------------------------------------------------
# the golden file: the JAX package's eval, and closed-loop trajectories
# ---------------------------------------------------------------------------

def jax_eval(env_id, episodes, horizon, seed=0):
  """The JAX package's deterministic eval of the shipped policy from the
  env's reset of `seed`'s keys: returns (N,) and solved flags (N, H), both
  counting no step after an episode's first done. An env whose reset
  draws nothing (the leg's stand and walk: the same state, observation and
  info for every key) has one episode, run once and counted `episodes`
  times (its JAX step costs ~0.4 s per env on a CPU)."""
  env = myosuite_tpu.make(env_id)
  jp, ts = jax_learner(env_id)
  pol = jp.make_policy_fn(deterministic=True)
  reset = jax.jit(jax.vmap(env.reset))
  keys = jax.random.split(jax.random.PRNGKey(seed), episodes)
  two = reset(keys[:2])
  leaves = [two.data.qpos, two.data.qvel, two.obs["state"],
            *(v for k, v in two.info.items() if k != "rng")]
  same = all(np.array_equal(np.asarray(a[0]), np.asarray(a[1]))
             for a in leaves)
  n = 1 if same else episodes
  state = reset(keys[:n])
  step = jax.jit(lambda s: jax.vmap(env.step)(s, pol(ts, s.obs["state"])))
  alive = np.ones(n, np.float32)
  total = np.zeros(n, np.float32)
  solved = []
  for _ in range(horizon):
    state = step(state)
    s = np.asarray(state.metrics.get("solved", np.zeros(n))) > 0
    solved.append(alive * s)
    total = total + np.asarray(state.reward) * alive
    alive = alive * (1.0 - np.asarray(state.done))
  reps = episodes // n
  return np.tile(total, reps), np.tile(np.stack(solved, 1), (reps, 1))


def jax_closed_loop(env_id, batch, steps, seed=0):
  """The JAX reset and `steps` control steps under the shipped policy."""
  env = myosuite_tpu.make(env_id)
  jp, ts = jax_learner(env_id)
  pol = jp.make_policy_fn(deterministic=True)
  state = jax.jit(jax.vmap(env.reset))(
      jax.random.split(jax.random.PRNGKey(seed), batch))
  step = jax.jit(lambda s: jax.vmap(env.step)(s, pol(ts, s.obs["state"])))
  out = {"qpos0": np.asarray(state.data.qpos),
         "qvel0": np.asarray(state.data.qvel)}
  if "target_angles" in state.info:
    out["target0"] = np.asarray(state.info["target_angles"])
  rec = {k: [] for k in FIELDS}
  for _ in range(steps):
    state = step(state)
    d = state.data
    for k, v in zip(FIELDS, (state.obs["state"], state.reward, state.done,
                             d.qpos, d.qvel, d.act)):
      rec[k].append(np.asarray(v))
  out.update({k: np.stack(v) for k, v in rec.items()})
  return out


def write_golden():
  """The JAX eval of every policy (EVAL_EPISODES episodes of
  EVAL_HORIZON steps: returns, solved steps, success in percent) and the
  closed-loop goldens with their tolerances: 10x the CPU port's largest
  gap, at least 1e-4 of max(1, the field's scale)."""
  out = {}
  for env_id, tag in TAGS.items():
    returns, solved = jax_eval(env_id, EVAL_EPISODES, EVAL_HORIZON)
    out[f"{tag}_returns"] = returns
    out[f"{tag}_solved_steps"] = solved.sum(1)
    out[f"{tag}_success"] = np.float64(jobs_vec.evaluate_success(solved))
    out[f"{tag}_horizon"] = np.int32(EVAL_HORIZON)
    print(f"{env_id}: JAX success {out[f'{tag}_success']:.1f}%, mean "
          f"return {returns.mean():.3f} over {EVAL_EPISODES} episodes")
  for tag, (env_id, batch, steps) in CLOSED_LOOP.items():
    out.update({f"{tag}_{k}": v for k, v in
                jax_closed_loop(env_id, batch, steps).items()})
  for tag in CLOSED_LOOP:
    ours = pretrained.closed_loop(out, tag, CLOSED_LOOP[tag][0], "cpu")
    for k in FIELDS:
      ref = out[f"{tag}_{k}"]
      gap = float(np.abs(ours[k] - ref).max())
      tol = max(10 * gap, 1e-4 * max(float(np.abs(ref).max()), 1.0))
      out[f"atol_{tag}_{k}"] = np.float64(tol)
      print(f"closed loop {tag} {k}: gap {gap:.3e}, tolerance {tol:.3e}")
  np.savez_compressed(GOLDEN, **out)
  print("wrote", GOLDEN)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--export-pretrained", action="store_true")
  parser.add_argument("--out", default=pretrained.ROOT)
  parser.add_argument("--envs", nargs="+", default=list(pretrained.ENV_IDS))
  parser.add_argument("--no-golden", action="store_true")
  args = parser.parse_args(argv)
  if not args.export_pretrained:
    parser.error("nothing to do: pass --export-pretrained")
  export_pretrained(args.out, args.envs)
  if not args.no_golden:
    write_golden()


if __name__ == "__main__":
  main()


# ---------------------------------------------------------------------------
# obs_vec, the gym adapter, the suites
# ---------------------------------------------------------------------------

def test_obs_vec_matches_jax_exactly():
  """The codec on a dict of a scalar, a vector and a matrix: the flat
  vector, the index map, the split of (3, 4, size) paths, the path
  rewards and evaluate_success, equal to the JAX package's."""
  rng = np.random.default_rng(0)
  obs = {"a": np.float32(1.5), "b": rng.normal(size=4).astype(np.float32),
         "c": rng.normal(size=(2, 3)).astype(np.float32)}
  keys = ("c", "a", "b")
  jcodec = jobs_vec.ObsVec(keys, obs)
  codec = obs_vec.ObsVec(keys, {k: torch.tensor(v) for k, v in obs.items()})
  assert codec.size == jcodec.size == 11
  assert codec.index_map() == jcodec.index_map()
  vec = codec.obsdict2obsvec({k: torch.tensor(v) for k, v in obs.items()})
  np.testing.assert_array_equal(vec.numpy(), jcodec.obsdict2obsvec(obs))
  paths = rng.normal(size=(3, 4, 11)).astype(np.float32)
  got = codec.obsvec2obsdict(torch.from_numpy(paths))
  want = jcodec.obsvec2obsdict(jnp.asarray(paths))
  for k in keys:
    assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got[k].numpy(), want[k])
  reward = lambda d: {"r": (d["b"] ** 2).sum(-1) - d["a"][..., 0]}
  np.testing.assert_array_equal(
      obs_vec.compute_path_rewards(torch.from_numpy(paths), codec,
                                   reward)["r"].numpy(),
      jobs_vec.compute_path_rewards(jnp.asarray(paths), jcodec,
                                    reward)["r"])
  solved = [np.arange(10) > k for k in (2, 3, 4, 5, 8)]
  assert obs_vec.evaluate_success(solved) == jobs_vec.evaluate_success(
      solved) == 40.0
  assert obs_vec.evaluate_success(torch.from_numpy(np.stack(solved))) == 40.0
  assert obs_vec.evaluate_success([]) == jobs_vec.evaluate_success([]) == 0.0


def test_gym_adapter_with_gymnasium():
  """GymEnv over the elbow on the CPU: gymnasium spaces, a seeded reset
  that repeats, numpy obs, a float reward, two bools, numpy metrics;
  render gives the env's frame as (480, 640, 3) uint8 numpy."""
  env = gym_adapter.GymEnv("MtxElbowPoseRandom-v0", device="cpu")
  import gymnasium
  assert isinstance(env, gymnasium.Env)
  assert env.observation_space.shape == (9,)
  assert env.action_space.shape == (6,)
  obs, info = env.reset(seed=3)
  again, _ = env.reset(seed=3)
  np.testing.assert_array_equal(obs, again)
  assert isinstance(obs, np.ndarray) and obs.shape == (9,) and info == {}
  out = env.step(np.full(6, 0.2, np.float32))
  obs, reward, terminated, truncated, info = out
  assert isinstance(obs, np.ndarray) and obs.shape == (9,)
  assert isinstance(reward, float) and np.isfinite(reward)
  assert isinstance(terminated, bool) and isinstance(truncated, bool)
  assert all(isinstance(v, np.ndarray) for v in info.values())
  assert "solved" in info
  frame = env.render()
  assert isinstance(frame, np.ndarray) and frame.dtype == np.uint8
  assert frame.shape == (480, 640, 3) and frame.any()


def test_gym_adapter_without_gymnasium(monkeypatch):
  """With gymnasium unimportable the adapter is a plain class with no
  spaces, and still resets and steps."""
  monkeypatch.setitem(sys.modules, "gymnasium", None)
  plain = importlib.reload(gym_adapter)
  try:
    assert plain.gym is None and plain.GymEnv.__mro__[1] is object
    env = plain.GymEnv("MtxElbowPoseRandom-v0", device="cpu")
    assert not hasattr(env, "observation_space")
    env.reset(seed=0)
    obs, reward, *_ = env.step(np.zeros(6, np.float32))
    assert obs.shape == (9,) and np.isfinite(reward)
  finally:
    monkeypatch.undo()
    importlib.reload(gym_adapter)


def test_suite_lists_match_jax():
  """The package-level suite lists equal the JAX package's."""
  for name in ("myosuite_myobase_suite", "myosuite_myochal_suite",
               "myosuite_myodm_suite", "myosuite_myoedit_suite"):
    got, want = getattr(myosuite_tpu_torch, name), getattr(myosuite_tpu,
                                                           name)
    assert got == want and len(got) > 0, name
  with pytest.raises(AttributeError):
    myosuite_tpu_torch.myosuite_nosuch_suite


# ---------------------------------------------------------------------------
# the reflex controller
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legs():
  """(port leg env on the CPU, JAX leg env, port state after 3 control
  steps of different random stimulations per env)."""
  env = myosuite_tpu_torch.make("MtxLegWalk-v0", device="cpu")
  jenv = myosuite_tpu.make("MtxLegWalk-v0")
  g = torch.Generator().manual_seed(0)
  state = env.reset(g, 3)
  for _ in range(3):
    state = env.step_ctrl(state, torch.rand(3, env.action_size,
                                            generator=g))
  return env, jenv, state


def _jax_gait():
  with open(GAIT) as f:
    gains = json.load(f)["params"]
  return jreflex.ReflexParams(**{k: jnp.float32(v) for k, v in
                                 gains.items()})


@pytest.mark.parametrize("which", ["default", "gait"])
def test_reflex_matches_jax(legs, which):
  """The controller's stimulations on a batch of three leg states against
  the JAX ReflexController.__call__ on each env's row (a namespace of the
  port's qpos, qvel, actuator_force, actuator_length, contact_force and
  time): atol 1e-5, with default_params() and with reflex_gait.json's
  gains (1e-36 to 4e37)."""
  env, jenv, state = legs
  ctl = reflex.ReflexController(env)
  jctl = jreflex.ReflexController(jenv)
  params = reflex.params_from_json(GAIT) if which == "gait" else None
  jparams = _jax_gait() if which == "gait" else None
  got = ctl(state.data, params)
  assert got.shape == (3, env.action_size)
  d = state.data
  for i in range(3):
    row = types.SimpleNamespace(**{
        k: jnp.asarray(getattr(d, k)[i].numpy())
        for k in ("qpos", "qvel", "actuator_force", "actuator_length",
                  "contact_force", "time")})
    assert_close(f"reflex {which} env {i}", got[i], jctl(row, jparams),
                 atol=1e-5)
  assert bool(((got >= 0) & (got <= 1)).all())


def test_reflex_tables_match_the_jax_leg():
  """The committed cfg_reflex_* tables of both leg model files equal what
  the JAX controller reads with MuJoCo: the group masks (each actuator
  named "<side>_<member>"), the feet's contact-slot masks, the hip-flexion
  qpos addresses and the body weight."""
  import mujoco
  jenv = myosuite_tpu.make("MtxLegWalk-v0")
  jctl = jreflex.ReflexController(jenv)
  mj = jenv.mj_model
  names = [mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_ACTUATOR.value, i)
           for i in range(mj.nu)]
  for fname in ("myoleg.npz", "myoleg_terrain.npz"):
    with np.load(os.path.join(registry.ASSETS, fname)) as z:
      tables = registry.reflex_tables_from_npz({k: z[k] for k in z.files})
    assert list(map(str, tables["group_names"])) == list(reflex.GROUPS)
    for i, side in enumerate(reflex.SIDES):
      for j, (group, members) in enumerate(reflex.GROUPS.items()):
        mask = tables["masks"][i, j]
        np.testing.assert_array_equal(mask, jctl._masks[side][group])
        assert {names[a] for a in np.flatnonzero(mask)} == {
            f"{side}_{m}" for m in members}, (side, group)
      np.testing.assert_array_equal(tables["grf"][i], jctl._grf[side])
      assert int(tables["hip_qadr"][i]) == jctl._hip_qadr[side]
    assert float(tables["weight"]) == jctl._weight
  env = myosuite_tpu_torch.make("MtxLegStand-v0", device="cpu")
  assert "reflex" in env.config
  with pytest.raises(ValueError, match="reflex tables"):
    reflex.ReflexController(
        myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu"))


def test_reflex_rollout_stays_in_unit_interval(legs):
  """Three control steps of the shipped gains through step_ctrl: every
  stimulation finite and in [0, 1], the per-step outputs (3, batch)."""
  env = legs[0]
  ctl = reflex.ReflexController(env, reflex.params_from_json(GAIT))
  state, out = ctl.rollout(torch.Generator().manual_seed(0), 3, batch=2)
  assert {k: tuple(v.shape) for k, v in out.items()} == {
      "reward": (3, 2), "solved": (3, 2), "x": (3, 2), "height": (3, 2),
      "stim": (3, 2, env.action_size), "x0": (2,)}
  assert bool(torch.isfinite(out["stim"]).all())
  assert bool(((out["stim"] >= 0) & (out["stim"] <= 1)).all())
  assert bool(torch.isfinite(state.data.qpos).all())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.fixture
def short_elbow(monkeypatch):
  """A registered elbow variant with 3-step episodes (cheap evals)."""
  for table in ("_REGISTRY", "_ALIASES", "_SUITES"):
    monkeypatch.setattr(registry, table, dict(getattr(registry, table)))
  return registry.register_env_variant(
      "MtxElbowPoseRandom-v0", {"max_episode_steps": 3}, silent=True)


@pytest.mark.parametrize("algo", ["ppo", "sac", "npg"])
def test_launcher_runs_each_algo_on_the_cpu(short_elbow, algo, tmp_path,
                                            capsys):
  """launcher.main at a tiny budget with --device cpu: the job's files
  (config.json with the algo's defaults, metrics.jsonl, result.json, a
  final checkpoint; for PPO train.log and ckpt/ too) and the printed JSON
  list, as the JAX launcher writes them."""
  out = tmp_path / "sweep"
  nenv = {"ppo": 4, "sac": 4, "npg": 2}[algo]
  steps = {"ppo": 40, "sac": 16, "npg": 100}[algo]
  launcher.main(["--envs", short_elbow, "--seeds", "3", "--num_timesteps",
                 str(steps), "--num_envs", str(nenv), "--num_evals", "1",
                 "--output_dir", str(out), "--algo", algo,
                 "--device", "cpu"])
  printed = capsys.readouterr().out
  job = out / f"{short_elbow.replace('-', '_')}_seed3"
  cfg = json.loads((job / "config.json").read_text())
  assert cfg["env"] == short_elbow and cfg["seed"] == 3
  assert cfg["num_envs"] == nenv and cfg["num_timesteps"] == steps
  assert ("algo" in cfg) == (algo != "ppo")
  lines = (job / "metrics.jsonl").read_text().splitlines()
  assert len(lines) == 1 and json.loads(lines[0])["steps"] > 0
  result = json.loads((job / "result.json").read_text())
  assert result["env"] == short_elbow and result["steps"] > 0
  assert checkpoint.latest_step_dir(str(job / "final")) is not None
  if algo == "ppo":
    assert (job / "train.log").exists() and (job / "ckpt").is_dir()
    assert len(result["eval_history"]) == 1
  listed = json.loads(printed[printed.index("["):])
  assert listed == [{k: v for k, v in result.items()
                     if k != "eval_history"}]


# ---------------------------------------------------------------------------
# the pretrained policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_id", pretrained.ENV_IDS)
def test_pretrained_tensors_equal_the_orbax_checkpoint(env_id):
  """Every tensor of the committed train_state.pt equals the JAX
  package's orbax checkpoint restored (kernels and Adam moments
  transposed), bit for bit: params, mu, nu, Adam's count, the non-finite
  counters, the obs statistics and env_steps."""
  _, jts = jax_learner(env_id)
  path = pretrained.checkpoint_dir(env_id)
  assert os.path.basename(path) == os.path.basename(jax_checkpoint_dir(
      env_id))
  saved = torch.load(os.path.join(path, checkpoint.FILE),
                     weights_only=True)
  want = port_learner(jts)
  for part in ("policy_params", "value_params"):
    got, ref = saved[part], getattr(want, part)
    assert list(got) == list(ref)
    for k in ref:
      assert got[k].dtype == torch.float32
      assert torch.equal(got[k], ref[k]), (part, k)
  flat = lambda tree: np.concatenate([
      np.asarray(v).reshape(-1) for sd in tree
      for v in convert.state_dict_from_flax(sd).values()])
  adam = convert._adam_part(jts.opt_state.inner_state)
  for m in ("mu", "nu"):
    np.testing.assert_array_equal(saved["opt_state"][m][0].numpy(),
                                  flat(getattr(adam, m)))
  assert int(saved["opt_state"]["count"]) == int(adam.count)
  for k in ("notfinite_count", "last_finite", "total_notfinite"):
    assert int(saved["opt_state"][k]) == int(getattr(jts.opt_state, k)), k
  for k in ("count", "mean", "m2"):
    np.testing.assert_array_equal(saved["obs_stats"][k].numpy(),
                                  np.asarray(getattr(jts.obs_stats, k)))
  assert saved["env_steps"] == int(jts.env_steps)


def test_optax_state_converts_both_ways():
  """The walk policy's optax state (apply_if_finite over clip and a
  cosine-scheduled Adam) as the port's OptState and back: count, mu, nu
  as (policy, value) flax trees and the three counters, bit for bit."""
  _, jts = jax_learner("MtxLegWalk-v0")
  port = port_learner(jts)
  back = convert.optax_from_opt_state(port.opt_state, port.policy_params,
                                      port.value_params)
  adam = convert._adam_part(jts.opt_state.inner_state)
  assert int(back["count"]) == int(adam.count)
  for m in ("mu", "nu"):
    for got, want in zip(back[m], getattr(adam, m)):
      for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
  for k in ("notfinite_count", "last_finite", "total_notfinite"):
    np.testing.assert_array_equal(back[k], np.asarray(getattr(
        jts.opt_state, k)))


def test_exporter_writes_the_committed_files(tmp_path):
  """The exporter's command line (--export-pretrained, --no-golden) into
  a fresh directory: the elbow's file holds the committed tensors, and
  summary.json, reflex_gait.json and metrics.jsonl come beside it."""
  main(["--export-pretrained", "--no-golden", "--out", str(tmp_path),
        "--envs", "MtxElbowPoseRandom-v0"])
  sub = "MtxElbowPoseRandom_v0"
  step = os.path.basename(pretrained.checkpoint_dir("MtxElbowPoseRandom-v0"))
  fresh = torch.load(tmp_path / sub / step / checkpoint.FILE,
                     weights_only=True)
  committed = torch.load(os.path.join(pretrained.ROOT, sub, step,
                                      checkpoint.FILE), weights_only=True)
  flat = lambda x, p="": (
      [y for k in x for y in flat(x[k], f"{p}.{k}")] if isinstance(x, dict)
      else [y for i, v in enumerate(x) for y in flat(v, f"{p}[{i}]")]
      if isinstance(x, list) else [(p, x)])
  a, b = flat(fresh), flat(committed)
  assert [k for k, _ in a] == [k for k, _ in b]
  for (k, x), (_, y) in zip(a, b):
    assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), k
  for name in ("summary.json", "reflex_gait.json",
               os.path.join(sub, "metrics.jsonl")):
    assert (tmp_path / name).read_bytes() == open(
        os.path.join(pretrained.ROOT, name), "rb").read(), name
  with pytest.raises(SystemExit):
    main([])


def test_pretrained_elbow_solves_on_the_cpu():
  """The committed elbow policy, restored on the CPU with
  checkpoint.restore_learner, keeps two deterministic episodes solved for
  more than 5 steps (tests/test_pretrained.py asks it of the JAX package
  over a whole episode; here within the first 20 control steps)."""
  trainer, ts = pretrained.load("MtxElbowPoseRandom-v0", device="cpu")
  out = pretrained.evaluate(trainer, ts, torch.Generator().manual_seed(42),
                            batch=2, horizon=20)
  assert int(out["solved"].sum(1).min()) > 5, out["solved"].sum(1)
  assert out["success"] == 100.0


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("tag", list(CLOSED_LOOP))
def test_pretrained_closed_loop_golden(tag):
  """From the JAX reset, the port's restored policy on the port's own
  observations for 10 control steps: each field within the tolerance
  stored beside the JAX trajectory (chip_smoke.py holds the card to the
  same)."""
  golden = _golden()
  ours = pretrained.closed_loop(golden, tag, CLOSED_LOOP[tag][0], "cpu")
  for k in FIELDS:
    assert_close(f"{tag} {k}", ours[k], golden[f"{tag}_{k}"],
                 atol=float(golden[f"atol_{tag}_{k}"]))


def test_golden_holds_the_jax_eval_of_every_policy():
  """The golden file holds, per policy, the JAX package's eval over 512
  episodes of 100 steps, consistent with itself (success = episodes with
  more than 5 solved steps) and with summary.json's elbow (100%)."""
  golden = _golden()
  for tag in TAGS.values():
    solved = golden[f"{tag}_solved_steps"]
    assert solved.shape == golden[f"{tag}_returns"].shape == (EVAL_EPISODES,)
    assert int(golden[f"{tag}_horizon"]) == EVAL_HORIZON
    assert float(golden[f"{tag}_success"]) == 100.0 * np.mean(solved > 5)
  assert float(golden["elbow_success"]) == 100.0

"""The port's pose envs against the JAX package's, and its auto-reset.

PoseEnv over the elbow (nv = 1) and the finger (nv = 4) is held against
the JAX PoseEnv with the same reset poses, targets and actions, as
tests/test_torch_step.py::test_reach_env_matches_jax holds the reach task.
AutoResetWrapper is the port's own (the JAX wrapper works per env under
vmap): its selects, bookkeeping and NaN guard are checked directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
import myosuite_tpu_torch
from myosuite_tpu.envs import registry as jax_registry
from myosuite_tpu_torch.envs import registry
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from tests.test_torch_step import TRAJ_ATOL
from tests.torch_common import assert_close


@pytest.mark.parametrize("env_id", ["MtxElbowPoseRandom-v0",
                                    "MtxFingerPoseRandom-v0"])
def test_pose_env_matches_jax(env_id):
  """The slice as a whole: the port's PoseEnv (from its committed model
  file) against the JAX PoseEnv, with JAX's reset poses and targets and the
  same actions, 3 control steps. Tolerance: obs, reward and metrics to
  TRAJ_ATOL (1e-4: 30 substeps of float32 drift); done, the bonus and
  solved flags and step counts exactly."""
  b = 4
  jenv = myosuite_tpu.make(env_id)
  jstate = jax.jit(jax.vmap(jenv.reset))(
      jax.random.split(jax.random.PRNGKey(0), b))
  jstep = jax.jit(jax.vmap(jenv.step))
  tenv = myosuite_tpu_torch.make(env_id, device="cpu")
  qpos = torch.from_numpy(np.array(jstate.data.qpos))
  targets = torch.from_numpy(np.array(jstate.info["target_angles"]))
  tenv._sample_qpos = lambda generator, batch: qpos.clone()
  tenv._sample_target = lambda generator, batch: targets.clone()
  tstate = tenv.reset(torch.Generator().manual_seed(0), b)

  def compare(j, t, step):
    assert_close(f"{env_id} step {step} obs", t.obs["state"],
                 j.obs["state"], atol=TRAJ_ATOL)
    assert_close(f"{env_id} step {step} reward", t.reward, j.reward,
                 atol=TRAJ_ATOL)
    np.testing.assert_array_equal(t.done.numpy(), j.done)
    for k, v in j.metrics.items():
      exact = k in ("bonus_reward", "solved", "penalty_reward")
      np.testing.assert_allclose(t.metrics[k].numpy(), v, rtol=0,
                                 atol=0 if exact else TRAJ_ATOL, err_msg=k)
    np.testing.assert_array_equal(t.info["step_count"].numpy(),
                                  j.info["step_count"])

  compare(jstate, tstate, 0)
  rng = np.random.default_rng(1)
  # through numpy: the JAX step's metrics come out weak-typed, which would
  # make the jitted step compile a second time
  strong = lambda tree: jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                                     tree)
  for i in range(3):
    a = rng.uniform(-1, 1, (b, tenv.action_size)).astype(np.float32)
    jstate = strong(jstep(jstate, jnp.asarray(a)))
    tstate = tenv.step(tstate, torch.from_numpy(a))
    compare(jstate, tstate, i + 1)


def test_hand_pose_config_matches_jax():
  """MtxHandPose*: the JAX registry's pose_config over the hand's own
  joint ranges with pose_thd 1.0."""
  env = myosuite_tpu_torch.make("myoHandPoseFixed-v0", device="cpu")
  rng = env.model.jnt_range.numpy()
  want = jax_registry.pose_config("", rng[:, 0], rng[:, 1],
                                  fixed_target=True, pose_thd=1.0)
  cfg = env.config
  for k in ("ctrl_dt", "sim_dt", "max_episode_steps", "norm_actions",
            "reset_type", "pose_thd", "far_th", "fixed_target"):
    assert cfg[k] == want[k], k
  assert cfg["reward_weights"] == dict(want.reward_weights)
  np.testing.assert_array_equal(cfg["target_jnt_lo"], want.target_jnt_lo)
  np.testing.assert_array_equal(cfg["target_jnt_hi"], want.target_jnt_hi)
  assert env.action_size == 39 and env.model.nq == 23


def test_registry_ids_and_aliases():
  """Every id of the port is one of the JAX registry's; these have their
  aliases (tests/test_torch_conditions.py::test_registry_matches_jax holds
  the whole registry)."""
  want = {
      "MtxElbowPoseRandom-v0": ("MjxElbowPoseRandom-v0",
                                "myoElbowPose1D6MRandom-v0"),
      "MtxElbowPoseFixed-v0": ("MjxElbowPoseFixed-v0",
                               "myoElbowPose1D6MFixed-v0"),
      "MtxFingerPoseRandom-v0": ("MjxFingerPoseRandom-v0",
                                 "myoFingerPoseRandom-v0"),
      "MtxFingerPoseFixed-v0": ("MjxFingerPoseFixed-v0",
                                "myoFingerPoseFixed-v0"),
      "MtxFingerReachRandom-v0": ("myoFingerReachRandom-v0",),
      "MtxFingerReachFixed-v0": ("myoFingerReachFixed-v0",),
      "MtxHandPoseRandom-v0": ("MjxHandPoseRandom-v0", "myoHandPoseRandom-v0"),
      "MtxHandPoseFixed-v0": ("MjxHandPoseFixed-v0", "myoHandPoseFixed-v0"),
      "MtxHandReachRandom-v0": ("MjxHandReachRandom-v0",
                                "myoHandReachRandom-v0"),
      "MtxHandReachFixed-v0": ("MjxHandReachFixed-v0", "myoHandReachFixed-v0"),
      "MtxLegWalk-v0": ("myoLegWalk-v0",),
      "MtxLegStand-v0": ("myoLegReachFixed-v0", "myoLegStand-v0"),
      "MtxLegWalkRough-v0": ("myoLegRoughTerrainWalk-v0",),
      "MtxLegWalkHilly-v0": ("myoLegHillyTerrainWalk-v0",),
      "MtxLegWalkStairs-v0": ("myoLegStairTerrainWalk-v0",),
  }
  assert set(want) <= set(registry.registered_envs())
  assert set(registry.registered_envs()) <= set(
      jax_registry.registered_envs())
  for name, aliases in want.items():
    assert name in jax_registry.registered_envs()
    for a in aliases:
      assert registry.resolve(a) == name == jax_registry.resolve(a)


def _elbow(batch=4, **cfg):
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  env.config.update(cfg)
  wrapped = AutoResetWrapper(env)
  return env, wrapped, wrapped.reset(torch.Generator().manual_seed(0), batch)


def _expected_reset(state, env, batch):
  """The reset the wrapper's next step draws, from a copy of its
  generator."""
  g = torch.Generator()
  g.set_state(state.info["reset_generator"].get_state())
  return env.reset(g, batch)


def test_auto_reset_on_truncation_takes_the_reset_state():
  """max_episode_steps 1: every env truncates at its first step and takes
  the reset's data, obs and targets; terminal_obs is the obs from before
  the reset; the return is handed to returned_episode_return."""
  env, wrapped, state = _elbow(max_episode_steps=1)
  expect = _expected_reset(state, env, 4)
  action = torch.full((4, env.action_size), 0.3)
  inner = env.step(state, action)        # the same step, unwrapped
  out = wrapped.step(state, action)
  assert torch.equal(out.info["truncation"], torch.ones(4))
  assert torch.equal(out.done, torch.zeros(4))
  assert torch.equal(out.data.qpos, expect.data.qpos)
  assert torch.equal(out.data.act, expect.data.act)
  assert torch.equal(out.obs["state"], expect.obs["state"])
  assert torch.equal(out.info["target_angles"],
                     expect.info["target_angles"])
  assert torch.equal(out.info["terminal_obs"], inner.obs["state"])
  assert torch.equal(out.info["step_count"], torch.zeros(4, dtype=torch.int32))
  assert torch.equal(out.info["episode_return"], torch.zeros(4))
  assert torch.equal(out.info["returned_episode_return"], inner.reward)


def test_auto_reset_on_done_selects_per_env():
  """Env 1 is forced done at the second step: it alone takes the reset's
  data and targets; the others run on and keep accumulating their
  returns."""
  env, wrapped, state = _elbow()
  action = torch.full((4, env.action_size), 0.6)
  s1 = wrapped.step(state, action)
  assert torch.equal(s1.info["episode_return"], s1.reward)
  forced = torch.tensor([0.0, 1.0, 0.0, 0.0])
  env._get_done = lambda st: forced
  expect = _expected_reset(s1, env, 4)
  inner = env.step(s1, action)
  s2 = wrapped.step(s1, action)
  keep = torch.tensor([True, False, True, True])
  assert torch.equal(s2.done, forced)
  assert torch.equal(s2.data.qpos[1], expect.data.qpos[1])
  assert torch.equal(s2.info["target_angles"][1],
                     expect.info["target_angles"][1])
  assert torch.equal(s2.data.qpos[keep], inner.data.qpos[keep])
  assert torch.equal(s2.info["target_angles"][keep],
                     inner.info["target_angles"][keep])
  assert torch.equal(s2.info["terminal_obs"], inner.obs["state"])
  ep = s1.info["episode_return"] + inner.reward
  assert torch.equal(s2.info["episode_return"],
                     torch.where(keep, ep, torch.zeros(4)))
  assert torch.equal(s2.info["returned_episode_return"],
                     torch.where(keep, torch.zeros(4), ep))


def test_auto_reset_treats_nan_as_terminal():
  """A NaN in env 2's qvel: reward 0, done 1, finite obs, and that env
  reset; the other envs step exactly as without the NaN."""
  env, wrapped, state = _elbow()
  action = torch.full((4, env.action_size), 0.4)
  clean = wrapped.step(state, action)
  expect = _expected_reset(state, env, 4)
  qvel = state.data.qvel.clone()
  qvel[2] = float("nan")
  bad = wrapped.step(state.replace(data=state.data.replace(qvel=qvel)),
                     action)
  assert float(bad.reward[2]) == 0.0 and float(bad.done[2]) == 1.0
  assert bool(torch.isfinite(bad.obs["state"]).all())
  assert bool(torch.isfinite(bad.info["terminal_obs"]).all())
  assert torch.equal(bad.data.qpos[2], expect.data.qpos[2])
  others = torch.tensor([0, 1, 3])
  for got, want in ((bad.obs["state"], clean.obs["state"]),
                    (bad.reward, clean.reward), (bad.done, clean.done),
                    (bad.data.qpos, clean.data.qpos),
                    (bad.data.qvel, clean.data.qvel)):
    assert torch.equal(got[others], want[others])

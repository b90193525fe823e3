"""The shipped pretrained policies, and their deterministic evaluation.

Five PPO policies (3x64 policy and value MLPs with their observation
statistics and Adam state), converted from the JAX package's checkpoints
into the port's learner-only checkpoints, `<Env_v0>/step_<n>/
train_state.pt` beside this file (see README.md there):

  policy, ts = pretrained.load("MtxElbowPoseRandom-v0", device="cuda")
  out = pretrained.evaluate(policy, ts, generator, batch=4096, horizon=100)

`evaluate` runs the deterministic policy on a batch of fresh episodes of
the plain env (no auto-reset, `train.callbacks.deterministic_rollout`);
steps after an episode's first done count neither reward nor solved
steps, and an episode succeeds when `solved` holds for more than 5 steps
(`envs.obs_vec.evaluate_success`). `closed_loop` replays a closed-loop
golden: the policy from a stored reset of a JAX run.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np
import torch

from myosuite_tpu_torch.envs import obs_vec
from myosuite_tpu_torch.train import callbacks, checkpoint, ppo as ppo_mod
from myosuite_tpu_torch.train import running_stats

ROOT = os.path.dirname(os.path.abspath(__file__))
ENV_IDS = ("MtxElbowPoseRandom-v0", "MtxFingerPoseRandom-v0",
           "MtxHandReachRandom-v0", "MtxLegStand-v0", "MtxLegWalk-v0")
# the fields a closed-loop golden records after each control step
CLOSED_LOOP_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")


def checkpoint_dir(env_id: str) -> Optional[str]:
  """The newest `step_<n>` directory shipped for `env_id`, or None."""
  steps = glob.glob(os.path.join(ROOT, env_id.replace("-", "_"), "step_*"))
  return max(steps, key=lambda p: int(p.rsplit("_", 1)[1])) if steps \
      else None


def load(env_id: str, device="cuda", env=None):
  """(PPO trainer bound to `env` or a fresh `env_id` env, learner state
  restored from the shipped checkpoint). The state's env_state and
  generator are None: it acts, it does not train."""
  import myosuite_tpu_torch

  path = checkpoint_dir(env_id)
  if path is None:
    raise FileNotFoundError(f"no pretrained policy for {env_id}")
  env = env if env is not None else myosuite_tpu_torch.make(env_id,
                                                            device=device)
  return load_path(path, env)


def load_path(path: str, env):
  """(PPO trainer bound to `env`, the learner of the checkpoint at `path`,
  a `step_<n>` directory of a full or learner-only checkpoint)."""
  saved = torch.load(os.path.join(path, checkpoint.FILE), map_location="cpu",
                     weights_only=True)
  obs_dim = saved["obs_stats"]["mean"].shape[0]
  trainer = ppo_mod.PPO(env, ppo_mod.default_config())
  trainer.build_networks(obs_dim)
  pol, val = [{k: v.detach().clone() for k, v in net.state_dict().items()}
              for net in (trainer.policy, trainer.value)]
  target = ppo_mod.TrainState(
      policy_params=pol, value_params=val,
      opt_state=ppo_mod.init_opt_state([trainer._flatten(pol, val)]),
      obs_stats=running_stats.init(obs_dim, env.device), env_state=None,
      generator=None, env_steps=0)
  return trainer, checkpoint.restore_learner(path, target)


def start_from(env, state, qpos: torch.Tensor, qvel: torch.Tensor,
               **info):
  """`state` (a reset of `env` at the same batch) moved to the supplied
  qpos, qvel and info entries, with its observation recomputed: an
  episode that starts where another run's reset did."""
  data = env._make_data(qpos, qvel)
  info = {**state.info, **info}
  return state.replace(data=data, info=info, obs=env._get_obs(data, info))


def evaluate(trainer, ts, generator: torch.Generator, batch: int,
             horizon: int, on_step=None) -> Dict[str, torch.Tensor]:
  """`horizon` deterministic control steps of `batch` fresh episodes:
  {"returns" (B,), "solved" (B, horizon), "success" (percent, a float)},
  the solved flags zero after an episode's first done. `on_step(i,
  state)` sees the state after each step."""
  returns, solved = callbacks.deterministic_rollout(
      trainer.env._env, trainer.make_policy_fn(deterministic=True), ts,
      generator, batch, horizon, on_step)
  return {"returns": returns, "solved": solved,
          "success": obs_vec.evaluate_success(solved)}


def closed_loop(golden, tag: str, env_id: str, device="cuda"
                ) -> Dict[str, np.ndarray]:
  """The replay of a closed-loop golden (`golden[f"{tag}_qpos0"]` and
  the other fields of a JAX run of the same policy): from the stored
  reset (qpos0, qvel0 and target0 where present), the restored policy of
  `env_id` on the port's own observations for as many control steps as
  the golden holds. Returns each of CLOSED_LOOP_FIELDS stacked over the
  steps, as numpy."""
  trainer, ts = load(env_id, device=device)
  env = trainer.env._env
  f32 = lambda k: torch.tensor(golden[f"{tag}_{k}"], device=device)
  info = ({"target_angles": f32("target0")} if f"{tag}_target0" in golden
          else {})
  batch = golden[f"{tag}_qpos0"].shape[0]
  state = env.reset(torch.Generator(device).manual_seed(0), batch)
  state = start_from(env, state, f32("qpos0"), f32("qvel0"), **info)
  pol = trainer.make_policy_fn(deterministic=True)
  rec = {k: [] for k in CLOSED_LOOP_FIELDS}
  with torch.no_grad():
    for _ in range(golden[f"{tag}_obs"].shape[0]):
      state = env.step(state, pol(ts, state.obs["state"]))
      d = state.data
      for k, v in zip(CLOSED_LOOP_FIELDS, (state.obs["state"], state.reward,
                                           state.done, d.qpos, d.qvel,
                                           d.act)):
        rec[k].append(v.cpu().numpy())
  return {k: np.stack(v) for k, v in rec.items()}

"""Reach tasks: drive fingertip site(s) to Cartesian targets.

Behaviour of the JAX package's ReachEnv: obs = [qpos, qvel*dt, act,
tip_pos, reach_err]; rewards reach/bonus/penalty weighted 1/4/50; far_th
is infinite for the first two control steps of an episode; the bonus uses
near_th and 2*near_th shells; targets are resampled on the device at
episode boundaries.

Config keys: tip_sids, target_lo, target_hi (n_targets, 3), far_th,
fixed_target, ctrl_dt, sim_dt, max_episode_steps, reward_weights.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from benchmark.reference.envs.base import MyoEnv, State
from benchmark.reference.physics.types import Data, Model


class ReachEnv(MyoEnv):
  """Cartesian site-reaching task over any muscle model."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    dev = model.device
    self._tip_sids = torch.as_tensor(list(config["tip_sids"]),
                                     dtype=torch.long, device=dev)
    self.n_targets = len(self._tip_sids)
    self.near_th = self.n_targets * 0.0125
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    self._target_lo = f32(config["target_lo"]).reshape(self.n_targets, 3)
    self._target_hi = f32(config["target_hi"]).reshape(self.n_targets, 3)

  def _sample_targets(self, generator: torch.Generator,
                      batch: int) -> torch.Tensor:
    """(batch, n_targets, 3) targets, uniform in the target box."""
    lo, hi = self._target_lo, self._target_hi
    if self._config.get("fixed_target", False):
      return (0.5 * (lo + hi)).expand(batch, -1, -1).clone()
    u = self.rand(generator, batch, *lo.shape)
    return lo + (hi - lo) * u

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    qpos = m.qpos0.expand(batch, -1).clone()
    qvel = torch.zeros(batch, m.nv, device=self.device)
    targets = self._sample_targets(generator, batch)
    zero = torch.zeros(batch, device=self.device)
    info = {"generator": generator,
            "step_count": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device),
            "targets": targets, "truncation": zero}
    data = self._make_data(qpos, qvel)
    metrics = {"reach_reward": zero, "bonus_reward": zero,
               "penalty_reward": zero, "solved": zero}
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics=metrics, info=info)

  def _tip(self, data: Data) -> torch.Tensor:
    return data.site_xpos[:, self._tip_sids]

  def _dist(self, data: Data, info: Dict) -> torch.Tensor:
    err = (info["targets"] - self._tip(data)).flatten(1)
    return torch.linalg.vector_norm(err, dim=-1)

  def _far_th(self, data: Data) -> torch.Tensor:
    # infinite during the first two control steps of an episode
    warmup = 2.0 * self._config["ctrl_dt"]
    far = torch.full_like(data.time, self._config["far_th"] * self.n_targets)
    return torch.where(data.time > warmup, far,
                       torch.full_like(far, float("inf")))

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    tip = self._tip(data)
    err = info["targets"] - tip
    obs = torch.cat([data.qpos, data.qvel * self._config["sim_dt"],
                     data.act, tip.flatten(1), err.flatten(1)], dim=-1)
    return {"state": obs}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dist = self._dist(data, info)
    f = lambda x: x.to(torch.float32)
    return {
        "reach": -dist,
        "bonus": f(dist < 2 * self.near_th) + f(dist < self.near_th),
        "penalty": -f(dist > self._far_th(data)),
    }

  def _get_done(self, state: State) -> torch.Tensor:
    dist = self._dist(state.data, state.info)
    return (dist > self._far_th(state.data)).to(torch.float32)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    dist = self._dist(state.data, state.info)
    return {
        "reach_reward": rewards["reach"],
        "bonus_reward": rewards["bonus"],
        "penalty_reward": rewards["penalty"],
        "solved": (dist < self.near_th).to(torch.float32),
    }

  def _get_info(self, state: State) -> Dict:
    truncation, boundary = self._episode_boundary(state)
    info = state.info
    fresh = self._sample_targets(info["generator"], state.reward.shape[0])
    targets = torch.where(boundary[:, None, None], fresh, info["targets"])
    step_count = torch.where(boundary, torch.zeros_like(info["step_count"]),
                             info["step_count"])
    return {**info, "step_count": step_count, "targets": targets,
            "truncation": truncation}

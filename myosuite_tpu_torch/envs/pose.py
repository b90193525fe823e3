"""Pose-matching tasks: drive the joints to target angles.

Behaviour of the JAX package's PoseEnv: obs = [qpos, qvel*dt, act,
target - qpos]; rewards pose / act_reg / bonus / penalty weighted 1/1/4/50;
done when the pose distance exceeds far_th; targets resampled on the device
at episode boundaries; reset_type "random" draws qpos uniformly in
jnt_range (any other value starts at qpos0).

Config keys: target_jnt_lo, target_jnt_hi (nq,), target_jnt_value
(optional, for fixed targets), fixed_target, reset_type, pose_thd, far_th,
ctrl_dt, sim_dt, max_episode_steps, reward_weights.

`ElbowExoPoseEnv` adds a payload on the forearm, drawn per episode from
weight_range and simulated through a per-env model, and an exoskeleton
torque exo_assist x qfrc_bias held over each control step; its config also
has payload_body (the forearm's body id), weight_range and exo_assist.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from myosuite_tpu_torch.envs.base import MyoEnv, State
from myosuite_tpu_torch.physics import types
from myosuite_tpu_torch.physics.types import Data, Model


class PoseEnv(MyoEnv):
  """Target-angle pose task over any muscle model."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=model.device).reshape(-1)
    self._target_lo = f32(config["target_jnt_lo"])
    self._target_hi = f32(config["target_jnt_hi"])
    value = config.get("target_jnt_value")
    self._target_value = None if value is None else f32(value)

  def _sample_target(self, generator: torch.Generator,
                     batch: int) -> torch.Tensor:
    """(batch, nq) targets, uniform in [target_jnt_lo, target_jnt_hi)."""
    lo, hi = self._target_lo, self._target_hi
    if self._config.get("fixed_target", False):
      fixed = (0.5 * (lo + hi) if self._target_value is None
               else self._target_value)
      return fixed.expand(batch, -1).clone()
    u = torch.rand((batch,) + lo.shape, generator=generator,
                   device=lo.device)
    return lo + (hi - lo) * u

  def _sample_qpos(self, generator: torch.Generator,
                   batch: int) -> torch.Tensor:
    m = self._model
    if self._config.get("reset_type", "random") != "random":
      return m.qpos0.expand(batch, -1).clone()
    lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
    u = torch.rand((batch, m.nq), generator=generator, device=self.device)
    return lo + (hi - lo) * u

  def reset(self, generator: torch.Generator, batch: int) -> State:
    qpos = self._sample_qpos(generator, batch)
    qvel = torch.zeros(batch, self._model.nv, device=self.device)
    target = self._sample_target(generator, batch)
    zero = torch.zeros(batch, device=self.device)
    info = {"generator": generator,
            "step_count": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device),
            "target_angles": target, "truncation": zero}
    data = self._make_data(qpos, qvel)
    metrics = {"pose_reward": zero, "bonus_reward": zero,
               "act_reg_reward": zero, "penalty_reward": zero,
               "solved": zero}
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics=metrics, info=info)

  def _pose_dist(self, data: Data, info: Dict) -> torch.Tensor:
    return torch.linalg.vector_norm(info["target_angles"] - data.qpos,
                                    dim=-1)

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    obs = torch.cat([data.qpos, data.qvel * self._config["sim_dt"],
                     data.act, info["target_angles"] - data.qpos], dim=-1)
    return {"state": obs}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    cfg = self._config
    pose_dist = self._pose_dist(data, info)
    f = lambda x: x.to(torch.float32)
    return {
        "pose": -pose_dist,
        "act_reg": -torch.linalg.vector_norm(data.act, dim=-1),
        "bonus": (f(pose_dist < cfg["pose_thd"])
                  + f(pose_dist < 1.5 * cfg["pose_thd"])),
        "penalty": -f(pose_dist > cfg["far_th"]),
    }

  def _get_done(self, state: State) -> torch.Tensor:
    pose_dist = self._pose_dist(state.data, state.info)
    return (pose_dist > self._config["far_th"]).to(torch.float32)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    pose_dist = self._pose_dist(state.data, state.info)
    return {
        "pose_reward": rewards["pose"],
        "bonus_reward": rewards["bonus"],
        "act_reg_reward": rewards["act_reg"],
        "penalty_reward": rewards["penalty"],
        "solved": (pose_dist < self._config["pose_thd"]).to(torch.float32),
    }

  def _get_info(self, state: State) -> Dict:
    truncation, boundary = self._episode_boundary(state)
    info = state.info
    fresh = self._sample_target(info["generator"], state.reward.shape[0])
    target = torch.where(boundary[:, None], fresh, info["target_angles"])
    step_count = torch.where(boundary, torch.zeros_like(info["step_count"]),
                             info["step_count"])
    return {**info, "step_count": step_count, "target_angles": target,
            "truncation": truncation}


def payload_from_draws(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
  """(B,) uniform draws on [0, 1) -> payload masses in [lo, hi)."""
  return u * (hi - lo) + lo


class ElbowExoPoseEnv(PoseEnv):
  """Elbow pose with a payload on the forearm, drawn per episode, and an
  exoskeleton assist torque (the JAX package's ElbowExoPoseEnv).

  The payload (info["payload_mass"], appended to the observation) adds to
  the forearm's mass and scales its inertia by 1 + payload / mass, through
  a per-env model; the exo applies exo_assist x qfrc_bias, taken at the
  start of each control step and held for all its substeps.
  """

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    self._payload_body = int(self._config["payload_body"])

  def _model_for_step(self, info: Dict) -> Model:
    m = self._model
    extra = info["payload_mass"]
    fb = self._payload_body
    mass = m.body_mass.expand(extra.shape[0], -1).clone()
    inertia = m.body_inertia.expand(extra.shape[0], -1, -1).clone()
    mass[:, fb] = m.body_mass[fb] + extra
    inertia[:, fb] = m.body_inertia[fb] * (
        1.0 + extra / m.body_mass[fb])[:, None]
    return types.per_env_model(m, body_mass=mass, body_inertia=inertia)

  def _sample_payload(self, generator: torch.Generator,
                      batch: int) -> torch.Tensor:
    lo, hi = self._config["weight_range"]
    u = torch.rand(batch, generator=generator, device=self.device)
    return payload_from_draws(u, float(lo), float(hi))

  def reset(self, generator: torch.Generator, batch: int) -> State:
    state = super().reset(generator, batch)
    info = {**state.info,
            "payload_mass": self._sample_payload(generator, batch)}
    return state.replace(info=info, obs=self._get_obs(state.data, info))

  def _step_simulation(self, state: State, ctrl: torch.Tensor) -> State:
    assist = self._config.get("exo_assist", 0.0)
    if assist:
      state = state.replace(data=state.data.replace(
          qfrc_applied=assist * state.data.qfrc_bias))
    return super()._step_simulation(state, ctrl)

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    base = super()._get_obs(data, info)["state"]
    payload = info.get("payload_mass")
    if payload is None:       # the base reset's obs, before the draw
      payload = base.new_zeros(base.shape[0])
    return {"state": torch.cat([base, payload[:, None]], -1)}

  def _get_info(self, state: State) -> Dict:
    info = super()._get_info(state)
    _, boundary = self._episode_boundary(state)
    fresh = self._sample_payload(info["generator"], boundary.shape[0])
    info["payload_mass"] = torch.where(boundary, fresh,
                                       state.info["payload_mass"])
    return info

"""Reference-motion tracking tasks (the JAX package's TrackEnv and
ObjTrackEnv, the MyoDM role).

`TrackEnv` tracks a joint-space reference motion with a muscle model: obs
= qpos, qvel dt, act, the reference's qpos error and qvel error dt;
rewards pose exp(-2 |qpos err|), vel exp(-0.1 |qvel err|), bonus, penalty;
done on a large tracking error or at the motion's end.

`ObjTrackEnv` tracks a hand + free-object reference (the MyoDM scenes):
obs = qpos, qvel dt, act, the hand's qpos and qvel errors and the
object's position error; rewards pose, object exp(-10 |obj err|), bonus
(near and lifted), penalty; done when the object is far or dropped (or at
a TRACK motion's end). A TRACK reference plays over time, a FIXED one
holds one object target, a RANDOM one draws an object target between its
two rows at every episode boundary.

Each env's time into its motion is info["motion_time"] (B,), advanced by
ctrl_dt a control step and reset to 0 at a boundary.

Config keys: pose_thd, far_th, ctrl_dt, sim_dt, max_episode_steps,
reward_weights; ObjTrackEnv also object_init (7,), drop_th, lift_z and
object_site (the object site's id).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from myosuite_tpu_torch.envs.base import MyoEnv, State
from myosuite_tpu_torch.logger.reference_motion import (RefType,
                                                       ReferenceMotion)
from myosuite_tpu_torch.physics.types import Data, Model


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


def _f(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.float32)


class _Tracking(MyoEnv):
  """Shared episode plumbing: a reference and a per-env motion time."""

  def __init__(self, model: Model, config: Dict[str, Any],
               reference: ReferenceMotion):
    super().__init__(model, config)
    if reference.time.device.type != model.device.type:
      raise ValueError(f"the reference is on {reference.time.device}, the "
                       f"model on {model.device}")
    self._ref = reference

  @property
  def reference(self) -> ReferenceMotion:
    return self._ref

  def _info(self, generator: torch.Generator, batch: int) -> Dict:
    zero = torch.zeros(batch, device=self.device)
    return {"generator": generator,
            "step_count": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device),
            "truncation": zero, "motion_time": zero}

  def _get_info(self, state: State) -> Dict:
    truncation, boundary = self._episode_boundary(state)
    info = state.info
    mtime = torch.where(boundary, torch.zeros_like(info["motion_time"]),
                        info["motion_time"] + self._config["ctrl_dt"])
    return {**info, "truncation": truncation, "motion_time": mtime,
            "step_count": torch.where(
                boundary, torch.zeros_like(info["step_count"]),
                info["step_count"])}


class TrackEnv(_Tracking):
  """Track a joint-space reference motion with a muscle model."""

  def reset(self, generator: torch.Generator, batch: int) -> State:
    qpos = self._ref.get_init()["robot"].expand(batch, -1).clone()
    qvel = torch.zeros(batch, self._model.nv, device=self.device)
    info = self._info(generator, batch)
    data = self._make_data(qpos, qvel)
    zero = info["truncation"]
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"pose_err": zero, "solved": zero},
                 info=info)

  def _errs(self, data: Data, info: Dict):
    ref = self._ref.get_reference(info["motion_time"])
    return ref["robot"] - data.qpos, ref["robot_vel"] - data.qvel

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    qpos_err, qvel_err = self._errs(data, info)
    return {"state": torch.cat([data.qpos, data.qvel * dt, data.act,
                                qpos_err, qvel_err * dt], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    qpos_err, qvel_err = self._errs(data, info)
    pose_dist, vel_dist = _norm(qpos_err), _norm(qvel_err)
    return {"pose": torch.exp(-2.0 * pose_dist),
            "vel": torch.exp(-0.1 * vel_dist),
            "bonus": 1.0 * _f(pose_dist < self._config["pose_thd"]),
            "penalty": -1.0 * _f(pose_dist > self._config["far_th"])}

  def _get_done(self, state: State) -> torch.Tensor:
    pose_dist = _norm(self._errs(state.data, state.info)[0])
    ended = state.info["motion_time"] >= self._ref.horizon
    return _f((pose_dist > self._config["far_th"]) | ended)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    pose_dist = _norm(self._errs(state.data, state.info)[0])
    return {"pose_err": pose_dist,
            "solved": _f(pose_dist < self._config["pose_thd"])}


def obj_target_from_draws(u: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor) -> torch.Tensor:
  """(B, 7) uniform draws on [0, 1) -> object poses between the rows lo
  and hi (each coordinate between the two), the quaternion normalized."""
  a, b = torch.minimum(lo, hi), torch.maximum(lo, hi)
  pose = u * (b - a) + a
  quat = pose[:, 3:7] / torch.clamp(_norm(pose[:, 3:7]), min=1e-8)[:, None]
  return torch.cat([pose[:, :3], quat], -1)


class ObjTrackEnv(_Tracking):
  """Track a hand + free-object reference motion (the MyoDM contract)."""

  def __init__(self, model: Model, config: Dict[str, Any],
               reference: ReferenceMotion):
    super().__init__(model, config, reference)
    self._nq_hand = model.nq - 7
    self._nv_hand = model.nv - 6
    self._obj_site = int(self._config["object_site"])
    self._object_init = torch.as_tensor(
        np.asarray(self._config["object_init"], np.float32),
        device=model.device)

  @property
  def _is_track(self) -> bool:
    return self._ref.ref_type == RefType.TRACK

  @property
  def _is_random(self) -> bool:
    return self._ref.ref_type == RefType.RANDOM

  def _sample_obj_target(self, generator: torch.Generator,
                         batch: int) -> torch.Tensor:
    u = torch.rand(batch, 7, generator=generator, device=self.device)
    return obj_target_from_draws(u, self._ref.object[0],
                                 self._ref.object[-1])

  def reset(self, generator: torch.Generator, batch: int) -> State:
    qpos = torch.cat([self._ref.robot[0, :self._nq_hand],
                      self._object_init]).expand(batch, -1).clone()
    qvel = torch.zeros(batch, self._model.nv, device=self.device)
    info = self._info(generator, batch)
    info["obj_target"] = (self._sample_obj_target(generator, batch)
                          if self._is_random else
                          self._ref.object[-1].expand(batch, -1).clone())
    data = self._make_data(qpos, qvel)
    zero = info["truncation"]
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"pose_err": zero, "obj_err": zero,
                                     "solved": zero}, info=info)

  def _ref_at(self, info: Dict):
    if self._is_track:
      ref = self._ref.get_reference(info["motion_time"])
      return (ref["robot"][:, :self._nq_hand],
              ref["robot_vel"][:, :self._nv_hand], ref["object"])
    # FIXED / RANDOM: hold the (drawn) object target
    return (self._ref.robot[0, :self._nq_hand],
            self._ref.robot_vel[0, :self._nv_hand], info["obj_target"])

  def _errs(self, data: Data, info: Dict):
    ref_q, ref_v, ref_obj = self._ref_at(info)
    return (ref_q - data.qpos[:, :self._nq_hand],
            ref_v - data.qvel[:, :self._nv_hand],
            ref_obj[:, :3] - data.site_xpos[:, self._obj_site])

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    qpos_err, qvel_err, obj_err = self._errs(data, info)
    return {"state": torch.cat([data.qpos, data.qvel * dt, data.act,
                                qpos_err, qvel_err * dt, obj_err], -1)}

  def _height(self, data: Data) -> torch.Tensor:
    return data.site_xpos[:, self._obj_site, 2]

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    qpos_err, _, obj_err = self._errs(data, info)
    obj_dist = _norm(obj_err)
    lifted = self._height(data) > self._config["lift_z"]
    return {"pose": torch.exp(-2.0 * _norm(qpos_err)),
            "object": torch.exp(-10.0 * obj_dist),
            "bonus": 1.0 * _f(obj_dist < 0.1) + 1.0 * _f(lifted),
            "penalty": -1.0 * _f(obj_dist > self._config["far_th"])}

  def _get_done(self, state: State) -> torch.Tensor:
    obj_err = self._errs(state.data, state.info)[2]
    done = ((_norm(obj_err) > self._config["far_th"])
            | (self._height(state.data) < self._config["drop_th"]))
    if self._is_track:
      done = done | (state.info["motion_time"] >= self._ref.horizon)
    return _f(done)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    qpos_err, _, obj_err = self._errs(state.data, state.info)
    obj_dist = _norm(obj_err)
    return {"pose_err": _norm(qpos_err), "obj_err": obj_dist,
            "solved": _f(obj_dist < 0.05)}

  def _get_info(self, state: State) -> Dict:
    info = super()._get_info(state)
    if self._is_random:
      _, boundary = self._episode_boundary(state)
      fresh = self._sample_obj_target(info["generator"], boundary.shape[0])
      info["obj_target"] = torch.where(boundary[:, None], fresh,
                                       info["obj_target"])
    return info


def make_cyclic_reference(jnt_range: np.ndarray, nq: int,
                          period: float = 2.0, horizon: float = 4.0,
                          dt: float = 0.02, device=None) -> ReferenceMotion:
  """Synthetic cyclic curl: each joint oscillates within its range (the
  (nq, 2) `jnt_range` of the model file), phases spread over a quarter
  turn."""
  t = np.arange(0.0, horizon + dt, dt)
  jnt_range = np.asarray(jnt_range, dtype=np.float64)
  lo, hi = jnt_range[:, 0], jnt_range[:, 1]
  mid = 0.5 * (lo + hi)
  amp = 0.35 * (hi - lo)
  phase = np.linspace(0, np.pi / 2, nq)
  qpos = mid[None, :] + amp[None, :] * np.sin(
      2 * np.pi * t[:, None] / period + phase[None, :])
  return ReferenceMotion.from_arrays(t, qpos, device=device)

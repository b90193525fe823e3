"""In-hand object manipulation tasks: hold, die reorient, pen twirl,
baoding balls, key turn.

Behaviour of the JAX package's manipulation envs (its reward weights come
with each model file):
  * ObjHold:  goal_dist, bonus, penalty
  * Reorient: pos_dist, rot_dist, bonus, penalty
  * PenTwirl: pos_align, rot_align, act_reg, drop, bonus
  * Baoding:  pos_dist_1, pos_dist_2, drop; the targets advance by
              goal_speed along an ellipse every control step
  * KeyTurn:  key_turn, IFtip_approach, THtip_approach, act_reg, bonus,
              penalty
Every episode starts at qpos0 at rest. Each random goal is a draw of
uniforms on [0, 1) followed by a transform (the `*_goal` functions), so
that a test can feed the JAX package and the port the same draws. Goals
are redrawn for the whole batch at every control step and taken where an
episode ends, with no host round trip.

The site ids and joint addresses that the JAX envs look up with MuJoCo
come from the model file's config (`registry.task_config_from_npz`):
"site_<name>", "qadr_<joint>" and "dadr_<joint>" for the names in each
class's SITES and JOINTS. Other config keys: ctrl_dt, sim_dt,
max_episode_steps, drop_th, goal_center, fixed_target, reward_weights, and
per task goal_span (hold), goal_rot_limit (die), goal_pitch_limit (pen),
goal_radius_x, goal_radius_y, goal_speed (baoding).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from benchmark.reference.envs.base import MyoEnv, State
from benchmark.reference.physics import math as pmath
from benchmark.reference.physics.types import Data, Model


def _f(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


def _unit(batch: int, n: int, device) -> torch.Tensor:
  """(batch, n) rows [1, 0, ..., 0]."""
  x = torch.zeros(batch, n, device=device)
  x[:, 0] = 1.0
  return x


# -- goal transforms of uniform draws on [0, 1) ------------------------------
# jax.random.uniform(minval=lo, maxval=hi) scales its draw u as
# u * (hi - lo) + lo; each transform below does the same.


def hold_goal(u: torch.Tensor, center: torch.Tensor,
              span: torch.Tensor) -> torch.Tensor:
  """(B, 3) draws -> goal positions in center +- span."""
  return center + (u * (span - (-span)) + (-span))


def reorient_goal(u: torch.Tensor, rot_limit: float) -> torch.Tensor:
  """(B, 3) draws -> goal quaternions of XYZ Euler angles in +-rot_limit."""
  return pmath.euler_to_quat(u * (rot_limit - (-rot_limit)) + (-rot_limit))


def pen_goal(u: torch.Tensor, pitch_limit: float) -> torch.Tensor:
  """(B, 2) draws -> unit goal directions: yaw in +-pi, pitch in
  +-pitch_limit."""
  v = u * 2.0 + (-1.0)
  yaw, pitch = v[:, 0] * math.pi, v[:, 1] * pitch_limit
  return torch.stack([torch.cos(yaw) * torch.cos(pitch),
                      torch.sin(yaw) * torch.cos(pitch), torch.sin(pitch)],
                     -1)


def baoding_phase(u: torch.Tensor) -> torch.Tensor:
  """(B,) draws -> target phases in [0, 2 pi)."""
  return u * (2 * math.pi)


def key_delta(u: torch.Tensor) -> torch.Tensor:
  """(B,) draws -> key angle offsets in [-0.1, 0.1)."""
  return u * 0.2 + (-0.1)


class _HandObjectEnv(MyoEnv):
  """Shared plumbing for hand + object scenes."""

  SITES: tuple = ()
  JOINTS: tuple = ()

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    self._site = {n: int(c["site_" + n]) for n in self.SITES}
    self._qadr = {n: int(c["qadr_" + n]) for n in self.JOINTS}
    self._dadr = {n: int(c["dadr_" + n]) for n in self.JOINTS}
    self._center = torch.as_tensor(c["goal_center"], dtype=torch.float32,
                                   device=model.device)

  @property
  def _fixed(self) -> bool:
    return bool(self._config.get("fixed_target", False))

  def _draw(self, generator: torch.Generator, *shape) -> torch.Tensor:
    return self.rand(generator, shape[0], *shape[1:])

  def _sxpos(self, data: Data, name: str) -> torch.Tensor:
    return data.site_xpos[:, self._site[name]]

  def _dropped(self, data: Data, name: str) -> torch.Tensor:
    return self._sxpos(data, name)[:, 2] < self._config["drop_th"]

  def _task_reset(self, generator: torch.Generator, qpos: torch.Tensor
                  ) -> tuple:
    """(qpos, the task's info entries) of a fresh batch."""
    return qpos, {}

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    qpos = m.qpos0.expand(batch, -1).clone()
    qvel = torch.zeros(batch, m.nv, device=self.device)
    qpos, task = self._task_reset(generator, qpos)
    zero = torch.zeros(batch, device=self.device)
    info = {"generator": generator,
            "step_count": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device),
            **task, "truncation": zero}
    data = self._make_data(qpos, qvel)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero}, info=info)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    return {"solved": self._solved(state)}

  def _solved(self, state: State) -> torch.Tensor:
    return torch.zeros_like(state.reward)

  def _resample(self, info: Dict, boundary: torch.Tensor) -> Dict:
    """The task's info entries after a step, redrawn where `boundary`."""
    return info

  def _get_info(self, state: State) -> Dict:
    truncation, boundary = self._episode_boundary(state)
    info = state.info
    step_count = torch.where(boundary, torch.zeros_like(info["step_count"]),
                             info["step_count"])
    return self._resample({**info, "truncation": truncation,
                           "step_count": step_count}, boundary)


class ObjHoldEnv(_HandObjectEnv):
  """Hold a ball at a goal position above the palm (ObjHoldRandom-v0)."""

  SITES = ("object_site",)
  JOINTS = ("object_free",)

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    self._span = torch.as_tensor(self._config["goal_span"],
                                 dtype=torch.float32, device=model.device)

  def _sample_goal(self, generator: torch.Generator, batch: int):
    if self._fixed:
      return self._center.expand(batch, -1).clone()
    return hold_goal(self._draw(generator, batch, 3), self._center,
                     self._span)

  def _task_reset(self, generator, qpos):
    return qpos, {"goal_pos": self._sample_goal(generator, qpos.shape[0])}

  def _obj_err(self, data: Data, info: Dict) -> torch.Tensor:
    return info["goal_pos"] - self._sxpos(data, "object_site")

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    qa, da = self._qadr["object_free"], self._dadr["object_free"]
    return {"state": torch.cat([
        data.qpos[:, :qa], data.qvel[:, :da] * self._config["sim_dt"],
        data.act, self._sxpos(data, "object_site"),
        self._obj_err(data, info)], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dist = _norm(self._obj_err(data, info))
    return {"goal_dist": -dist,
            "bonus": 1.0 * _f(dist < 0.04) + 1.0 * _f(dist < 0.02),
            "penalty": -1.0 * _f(self._dropped(data, "object_site"))}

  def _get_done(self, state: State) -> torch.Tensor:
    return _f(self._dropped(state.data, "object_site"))

  def _solved(self, state: State) -> torch.Tensor:
    return _f(_norm(self._obj_err(state.data, state.info)) < 0.02)

  def _resample(self, info, boundary):
    fresh = self._sample_goal(info["generator"], boundary.shape[0])
    return {**info, "goal_pos": torch.where(boundary[:, None], fresh,
                                            info["goal_pos"])}


class ReorientEnv(_HandObjectEnv):
  """Die reorientation to a goal orientation (MyoChallenge'22 die task)."""

  SITES = ("object_site",)
  JOINTS = ("object_free",)

  def _sample_goal_rot(self, generator: torch.Generator, batch: int):
    if self._fixed:
      return _unit(batch, 4, self.device)
    return reorient_goal(self._draw(generator, batch, 3),
                         float(self._config["goal_rot_limit"]))

  def _task_reset(self, generator, qpos):
    batch = qpos.shape[0]
    return qpos, {"goal_quat": self._sample_goal_rot(generator, batch),
                  "goal_pos": self._center.expand(batch, -1).clone()}

  def _errs(self, data: Data, info: Dict):
    qa = self._qadr["object_free"]
    pos_err = info["goal_pos"] - self._sxpos(data, "object_site")
    obj_quat = data.qpos[:, qa + 3:qa + 7]
    rot_err = pmath.quat_diff_vel(pmath.normalize(obj_quat),
                                  info["goal_quat"])
    return pos_err, rot_err

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    pos_err, rot_err = self._errs(data, info)
    qa, da = self._qadr["object_free"], self._dadr["object_free"]
    return {"state": torch.cat([
        data.qpos[:, :qa], data.qvel[:, :da] * self._config["sim_dt"],
        data.act, data.qpos[:, qa:qa + 7], info["goal_quat"], pos_err,
        rot_err], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    pos_err, rot_err = self._errs(data, info)
    pos_dist, rot_dist = _norm(pos_err), _norm(rot_err)
    return {"pos_dist": -pos_dist, "rot_dist": -rot_dist,
            "bonus": 1.0 * _f((pos_dist < 0.02) & (rot_dist < 0.3)),
            "penalty": -1.0 * _f(self._dropped(data, "object_site"))}

  def _get_done(self, state: State) -> torch.Tensor:
    return _f(self._dropped(state.data, "object_site"))

  def _solved(self, state: State) -> torch.Tensor:
    pos_err, rot_err = self._errs(state.data, state.info)
    return _f((_norm(pos_err) < 0.02) & (_norm(rot_err) < 0.3))

  def _resample(self, info, boundary):
    fresh = self._sample_goal_rot(info["generator"], boundary.shape[0])
    return {**info, "goal_quat": torch.where(boundary[:, None], fresh,
                                             info["goal_quat"])}


class PenTwirlEnv(_HandObjectEnv):
  """Rotate a pen in-hand to a target orientation (pen_v0 contract)."""

  SITES = ("object_site", "object_top")
  JOINTS = ("object_free",)

  def _sample_goal_dir(self, generator: torch.Generator, batch: int):
    if self._fixed:
      return _unit(batch, 3, self.device)
    return pen_goal(self._draw(generator, batch, 2),
                    float(self._config["goal_pitch_limit"]))

  def _task_reset(self, generator, qpos):
    batch = qpos.shape[0]
    return qpos, {"goal_dir": self._sample_goal_dir(generator, batch),
                  "goal_pos": self._center.expand(batch, -1).clone()}

  def _axis(self, data: Data) -> torch.Tensor:
    axis = self._sxpos(data, "object_top") - self._sxpos(data, "object_site")
    return axis / torch.clamp(_norm(axis), min=1e-9)[:, None]

  def _pos_err(self, data: Data, info: Dict) -> torch.Tensor:
    return info["goal_pos"] - self._sxpos(data, "object_site")

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    axis, goal = self._axis(data), info["goal_dir"]
    qa, da = self._qadr["object_free"], self._dadr["object_free"]
    return {"state": torch.cat([
        data.qpos[:, :qa], data.act, self._sxpos(data, "object_site"),
        data.qvel[:, da:da + 6] * self._config["sim_dt"], axis, goal,
        self._pos_err(data, info), axis - goal], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    pos_err = self._pos_err(data, info)
    rot_align = pmath.dot(self._axis(data), info["goal_dir"])
    act_mag = _norm(data.act) / max(self._model.na, 1)
    return {"pos_align": -_norm(pos_err), "rot_align": rot_align,
            "act_reg": -act_mag,
            "drop": -1.0 * _f(self._dropped(data, "object_site")),
            "bonus": 1.0 * _f((rot_align > 0.9) & (_norm(pos_err) < 0.075))}

  def _get_done(self, state: State) -> torch.Tensor:
    return _f(self._dropped(state.data, "object_site"))

  def _solved(self, state: State) -> torch.Tensor:
    return _f(pmath.dot(self._axis(state.data), state.info["goal_dir"])
              > 0.9)

  def _resample(self, info, boundary):
    fresh = self._sample_goal_dir(info["generator"], boundary.shape[0])
    return {**info, "goal_dir": torch.where(boundary[:, None], fresh,
                                            info["goal_dir"])}


class BaodingEnv(_HandObjectEnv):
  """Two baoding balls tracking rotating targets (baoding_v1 contract)."""

  SITES = ("ball1_site", "ball2_site")
  JOINTS = ("ball1_free", "ball2_free")

  def _sample_phase(self, generator: torch.Generator, batch: int):
    return baoding_phase(self._draw(generator, batch))

  def _task_reset(self, generator, qpos):
    batch = qpos.shape[0]
    if self._fixed:
      phase = torch.full((batch,), math.pi / 2, device=self.device)
    else:
      phase = self._sample_phase(generator, batch)
    return qpos, {"phase": phase}

  def _targets(self, phase: torch.Tensor):
    c = self._config
    rx, ry = c["goal_radius_x"], c["goal_radius_y"]
    zero = torch.zeros_like(phase)
    t1 = self._center + torch.stack([rx * torch.cos(phase),
                                     ry * torch.sin(phase), zero], -1)
    t2 = self._center + torch.stack([rx * torch.cos(phase + math.pi),
                                     ry * torch.sin(phase + math.pi), zero],
                                    -1)
    return t1, t2

  def _dists(self, data: Data, info: Dict):
    t1, t2 = self._targets(info["phase"])
    return (_norm(t1 - self._sxpos(data, "ball1_site")),
            _norm(t2 - self._sxpos(data, "ball2_site")))

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    t1, t2 = self._targets(info["phase"])
    p1, p2 = self._sxpos(data, "ball1_site"), self._sxpos(data, "ball2_site")
    d1, d2 = self._dadr["ball1_free"], self._dadr["ball2_free"]
    dt = self._config["sim_dt"]
    return {"state": torch.cat([
        data.qpos[:, :self._qadr["ball1_free"]], data.act, p1,
        data.qvel[:, d1:d1 + 3] * dt, p2, data.qvel[:, d2:d2 + 3] * dt, t1,
        t2, t1 - p1, t2 - p2], -1)}

  def _either_dropped(self, data: Data) -> torch.Tensor:
    return (self._dropped(data, "ball1_site")
            | self._dropped(data, "ball2_site"))

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    d1, d2 = self._dists(data, info)
    return {"pos_dist_1": -d1, "pos_dist_2": -d2,
            "drop": -1.0 * _f(self._either_dropped(data))}

  def _get_done(self, state: State) -> torch.Tensor:
    return _f(self._either_dropped(state.data))

  def _solved(self, state: State) -> torch.Tensor:
    d1, d2 = self._dists(state.data, state.info)
    return _f((d1 < 0.03) & (d2 < 0.03))

  def _resample(self, info, boundary):
    # the targets advance along their trajectory every control step
    phase = info["phase"] + self._config["goal_speed"]
    fresh = self._sample_phase(info["generator"], boundary.shape[0])
    return {**info, "phase": torch.where(boundary, fresh, phase)}


class KeyTurnEnv(_HandObjectEnv):
  """Turn a key with index finger and thumb (key_turn_v0 contract)."""

  SITES = ("key_site", "IFtip", "THtip")
  JOINTS = ("key_joint",)

  def _task_reset(self, generator, qpos):
    qa = self._qadr["key_joint"]
    if not self._fixed:
      qpos[:, qa] = qpos[:, qa] + key_delta(self._draw(generator,
                                                       qpos.shape[0]))
    return qpos, {"init_key": qpos[:, qa].clone()}

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    qa, da = self._qadr["key_joint"], self._dadr["key_joint"]
    key = self._sxpos(data, "key_site")
    return {"state": torch.cat([
        data.qpos[:, :qa], data.act, data.qpos[:, qa:qa + 1],
        data.qvel[:, da:da + 1] * self._config["sim_dt"],
        key - self._sxpos(data, "IFtip"), key - self._sxpos(data, "THtip")],
        -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    key = self._sxpos(data, "key_site")
    if_dist = _norm(key - self._sxpos(data, "IFtip"))
    th_dist = _norm(self._sxpos(data, "THtip") - key)
    act_mag = _norm(data.act) / max(self._model.na, 1)
    turned = info["init_key"] - data.qpos[:, self._qadr["key_joint"]]
    return {
        "key_turn": -data.qvel[:, self._dadr["key_joint"]],
        "IFtip_approach": -if_dist,
        "THtip_approach": -th_dist,
        "act_reg": -act_mag,
        "bonus": 1.0 * _f(turned > math.pi) + 1.0 * _f(turned > 2 * math.pi),
        "penalty": -1.0 * _f((if_dist > 0.1) | (th_dist > 0.15)),
    }

  def _solved(self, state: State) -> torch.Tensor:
    turned = (state.info["init_key"]
              - state.data.qpos[:, self._qadr["key_joint"]])
    return _f(turned > 2 * math.pi)


# the model file's object -> its env class
ENVS = {"hold": ObjHoldEnv, "die": ReorientEnv, "pen": PenTwirlEnv,
        "baoding": BaodingEnv, "key": KeyTurnEnv}

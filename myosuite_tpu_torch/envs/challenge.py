"""MyoChallenge envs: ChaseTag, Soccer, OSL RunTrack on the myoLeg;
Relocate, Bimanual and TableTennis on the myoArm.

Behaviour of the JAX package's challenge envs (their reward weights come
with each model file):
  * ChaseTag:   distance, lose, act_reg; a scripted opponent (a mocap
                body, moved every control step) on a patch arena; the
                agent chases (MtxChaseTag-v0) or evades
                (MtxChaseTagEvade-v0); win / lose / time-based score.
  * Soccer:     goal_scored, time_cost, act_reg, pain, ball_dist,
                goal_dist; a scripted goalkeeper (a mocap body); the goal
                flag sticks for the episode.
  * RunTrack:   sparse, solved, act_reg, pain, vel_reward; the OSL
                controller drives the prosthetic knee and ankle motors
                inside `step`, so the policy commands nu - 2 actuators.
  * Relocate:   pos_dist, lift_bonus, bonus, act_reg; the object's size,
                mass, inertia and friction drawn per episode and simulated
                through a per-env model (`_model_for_step`).
  * Bimanual:   reach_dist, act, fin_dis, pass_err; the prosthesis's
                position actuators take a linear map of the action onto
                their ctrlrange; five object-centric touch channels.
  * TableTennis: reach_dist, palm_dist, paddle_quat, torso_up, act_reg,
                sparse, solved, done_pen; a served ball, a sticky
                paddle_hit flag.
Every random draw is a uniform, normal or categorical draw followed by
the JAX package's transform, and the task's per-episode state is redrawn
for the whole batch at every control step and taken where an episode
ends, with no host round trip. (ChaseTag redraws its opponent there but
not its arena, as the JAX package does.)

The ids that the JAX envs look up with MuJoCo come from each model file's
config (`registry.task_config_from_npz`): site, body and geom ids,
joint qpos / dof addresses, the geom groups of the contact masks, and the
model's total body mass. Every contact mask is built over the model's
collision-pair table, slot for slot as the JAX package builds it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from myosuite_tpu_torch.envs import heightfields, opponents, osl
from myosuite_tpu_torch.envs.base import MyoEnv, State
from myosuite_tpu_torch.envs.locomotion import WalkEnv
from myosuite_tpu_torch.envs.wrappers import _pick_info
from myosuite_tpu_torch.physics import math as pmath
from myosuite_tpu_torch.physics import types
from myosuite_tpu_torch.physics.types import Data, DynType, Model


def _f(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


def _uniform(u: torch.Tensor, lo, hi) -> torch.Tensor:
  """Draws in [0, 1) -> [lo, hi), as jax.random.uniform scales them (the
  width hi - lo taken in float32)."""
  if isinstance(hi, torch.Tensor):
    return u * (hi - lo) + lo
  return u * float(np.float32(hi) - np.float32(lo)) + lo


def _slot_mask(model: Model, hit) -> torch.Tensor:
  """(ncon_max,) float32: 1.0 on every slot of each collision pair
  (geom1, geom2) for which hit(geom1, geom2)."""
  mask = []
  for p in np.asarray(model.collision_pairs):
    mask.extend([1.0 if hit(int(p[0]), int(p[1])) else 0.0] * int(p[2]))
  return torch.tensor(mask, dtype=torch.float32, device=model.device)


def contact_slot_mask(model: Model, geom_ids) -> torch.Tensor:
  """(ncon_max,) 1.0 where the contact slot involves any of geom_ids."""
  ids = set(int(g) for g in geom_ids)
  return _slot_mask(model, lambda g1, g2: g1 in ids or g2 in ids)


def _fresh_info(env: MyoEnv, generator: torch.Generator, batch: int,
                **task) -> Dict[str, Any]:
  zero = torch.zeros(batch, device=env.device)
  return {"generator": generator,
          "step_count": torch.zeros(batch, dtype=torch.int32,
                                    device=env.device),
          "truncation": zero, **task}


def _next_info(env: MyoEnv, state: State, **fresh) -> Dict[str, Any]:
  """The info after a control step: truncation, step_count back at 0 and
  each `fresh` entry taken where an episode ended."""
  truncation, boundary = env._episode_boundary(state)
  info = state.info
  out = {**info, "truncation": truncation,
         "step_count": torch.where(boundary,
                                   torch.zeros_like(info["step_count"]),
                                   info["step_count"])}
  for k, v in fresh.items():
    out[k] = _pick_info(boundary, v, info[k])
  return out


# info entries that are a scripted opponent's state
_STATES = {"opponent": opponents.OpponentState,
           "keeper": opponents.KeeperState}


def nested_info(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
  """Info entries from flat tensors: the "<entry>__<field>" keys of an
  opponent's or keeper's state gathered into its dataclass (policy and t
  as int32), the others as they are."""
  out: Dict[str, Any] = {}
  fields: Dict[str, Dict[str, torch.Tensor]] = {}
  for k, v in flat.items():
    entry, _, field = k.partition("__")
    if field:
      fields.setdefault(entry, {})[field] = (
          v.to(torch.int32) if field in ("policy", "t") else v)
    else:
      out[k] = v
  for entry, f in fields.items():
    out[entry] = _STATES[entry](**f)
  return out


def state_from(env: MyoEnv, state: State, qpos: torch.Tensor,
               qvel: torch.Tensor, info: Dict[str, Any],
               hfield: Optional[torch.Tensor] = None) -> State:
  """`state` (a fresh reset of `env`) moved to the given physics and task
  info entries, e.g. another run's reset: the data settled at qpos, qvel
  (and terrain), the mocap bodies placed and the obs taken anew."""
  info = {**state.info, **info}
  data = env._make_data(qpos, qvel, hfield=hfield)
  if hasattr(env, "_place_mocap"):
    data = env._place_mocap(data, info)
  return state.replace(data=data, obs=env._get_obs(data, info), info=info)


class _LegChallengeEnv(WalkEnv):
  """Shared plumbing of the leg tasks: the feet's ground reaction forces
  and the body block of the obs."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    self._body_weight = float(c["body_mass"]) * 9.81
    self._grf_mask_r = contact_slot_mask(model, c["grf_r_geoms"])
    self._grf_mask_l = contact_slot_mask(model, c["grf_l_geoms"])

  def _grf(self, data: Data) -> torch.Tensor:
    """(B, 2) right / left vertical ground reaction force / body weight."""
    r = pmath.fixed_sum(data.contact_force * self._grf_mask_r, -1)
    l = pmath.fixed_sum(data.contact_force * self._grf_mask_l, -1)
    return torch.stack([r, l], -1) / self._body_weight

  def _body_obs(self, data: Data) -> torch.Tensor:
    dt = self._config["sim_dt"]
    return torch.cat([
        data.qpos[:, 2:],                    # internal qpos (no world xy)
        data.qvel * dt,
        self._grf(data),
        self._torso_angle(data),
        data.qpos[:, 0:3],                   # root position
        data.qvel[:, 0:3],                   # root velocity
        data.ten_length,
        data.ten_velocity * dt,
        data.actuator_force * 1e-3,
        data.act,
    ], -1)


class ChaseTagEnv(_LegChallengeEnv):
  """Chase (or evade) a scripted opponent over a patch arena. Config keys
  beyond the walk's: arena_half, tag_radius, agent_role ("chase" or
  "evade"), hf_base, hf_extent."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    if model.hfield_geomid < 0:
      raise ValueError("ChaseTagEnv needs a model with a heightfield")
    self._hf_base = tuple(float(x) for x in config["hf_base"])
    self._hf_extent = tuple(float(x) for x in config["hf_extent"])
    self._hf_shape = (model.hfield_nrow, model.hfield_ncol)

  @property
  def _chaser(self) -> bool:
    return self._config.get("agent_role", "chase") == "chase"

  @property
  def _role_mode(self) -> int:
    return opponents.EVADE if self._chaser else opponents.CHASE

  def _new_opponent(self, generator: torch.Generator, batch: int):
    return opponents.reset_opponent(
        generator, batch, self.max_episode_steps,
        arena_half=self._config["arena_half"], mode=self._role_mode)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    half = self._config["arena_half"] * 0.6
    xy = _uniform(torch.rand(batch, 2, generator=generator,
                             device=self.device), -half, half)
    qpos = m.qpos0.expand(batch, -1).clone()
    qpos[:, 0:2] = xy
    qvel = torch.zeros(batch, m.nv, device=self.device)
    opp = self._new_opponent(generator, batch)
    hfield = heightfields.chasetag_arena(generator, batch, self._hf_shape)
    info = _fresh_info(self, generator, batch, opponent=opp)
    data = self._place_mocap(self._make_data(qpos, qvel, hfield=hfield),
                             info)
    zero = torch.zeros(batch, device=self.device)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero, "win": zero,
                                     "score": zero}, info=info)

  def _place_mocap(self, data: Data, info: Dict) -> Data:
    """The opponent's body at its pose (0.5 m up, turned by its heading)."""
    if self._model.nmocap < 1:
      return data
    pose = info["opponent"].pose
    pos = data.mocap_pos.clone()
    quat = data.mocap_quat.clone()
    pos[:, 0] = torch.cat([pose[:, :2], torch.full_like(pose[:, :1], 0.5)],
                          -1)
    half = torch.cos(pose[:, 2] / 2)
    quat[:, 0] = torch.stack([half, 0.0 * half, 0.0 * half,
                              torch.sin(pose[:, 2] / 2)], -1)
    return data.replace(mocap_pos=pos, mocap_quat=quat)

  def _step_simulation(self, state: State, ctrl: torch.Tensor) -> State:
    state = super()._step_simulation(state, ctrl)
    opp = opponents.step_opponent(
        state.info["opponent"], state.data.qpos[:, 0:2], self.dt,
        arena_half=self._config["arena_half"])
    info = {**state.info, "opponent": opp}
    return state.replace(data=self._place_mocap(state.data, info), info=info)

  def _opp_dist(self, data: Data, info: Dict) -> torch.Tensor:
    return _norm(info["opponent"].pose[:, :2] - data.qpos[:, 0:2])

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    opp = info["opponent"]
    hmap = heightfields.egocentric_heightmap(
        data.hfield_data, data.qpos[:, 0:2], self._root_yaw(data),
        self._hf_extent, base=self._hf_base)
    return {"state": torch.cat([
        self._body_obs(data), opp.pose, opp.vel,
        (hmap - data.qpos[:, 2, None, None]).reshape(data.batch, -1)], -1)}

  def _out_of_bounds(self, data: Data) -> torch.Tensor:
    half = self._config["arena_half"]
    return (data.qpos[:, 0].abs() > half) | (data.qpos[:, 1].abs() > half)

  def _lose(self, data: Data) -> torch.Tensor:
    return torch.maximum(self._fallen(data), _f(self._out_of_bounds(data)))

  def _win(self, state: State) -> torch.Tensor:
    if self._chaser:
      return _f(self._opp_dist(state.data, state.info)
                < self._config["tag_radius"])
    # the evader wins by lasting to the horizon
    return _f((state.info["step_count"] >= self.max_episode_steps)
              & (self._lose(state.data) == 0.0))

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    return {"distance": self._opp_dist(data, info),
            "lose": -self._lose(data),
            "act_reg": -torch.mean(torch.square(data.act), -1)}

  def _get_done(self, state: State) -> torch.Tensor:
    return torch.maximum(self._lose(state.data), self._win(state))

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    win = self._win(state)
    frac = _f(state.info["step_count"]) / self.max_episode_steps
    return {"solved": win, "win": win,
            "score": win * torch.clamp(1.0 - frac, min=0.0)}

  def _get_info(self, state: State) -> Dict:
    fresh = self._new_opponent(state.info["generator"],
                               state.reward.shape[0])
    return _next_info(self, state, opponent=fresh)


class SoccerEnv(_LegChallengeEnv):
  """Kick a ball past a scripted goalkeeper. Config keys beyond the
  walk's: goal_x, goal_half_width, keeper_reach, ball_qadr, ball_dadr."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    self._ball_qadr = int(self._config["ball_qadr"])
    self._ball_dadr = int(self._config["ball_dadr"])

  def _new_keeper(self, generator: torch.Generator, batch: int):
    return opponents.reset_keeper(generator, batch, self.max_episode_steps)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    dxy = _uniform(torch.rand(batch, 2, generator=generator,
                              device=self.device), -0.2, 0.2)
    qpos = m.qpos0.expand(batch, -1).clone()
    qpos[:, self._ball_qadr:self._ball_qadr + 2] += dxy
    qvel = torch.zeros(batch, m.nv, device=self.device)
    keeper = self._new_keeper(generator, batch)
    zero = torch.zeros(batch, device=self.device)
    info = _fresh_info(self, generator, batch, keeper=keeper, scored=zero)
    data = self._place_mocap(self._make_data(qpos, qvel), info)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero, "score": zero},
                 info=info)

  def _place_mocap(self, data: Data, info: Dict) -> Data:
    """The keeper's body on the goal line at its y."""
    if self._model.nmocap < 1:
      return data
    y = info["keeper"].pose[:, 0]
    pos = data.mocap_pos.clone()
    pos[:, 0] = torch.stack([torch.full_like(y, self._config["goal_x"] - 0.3),
                             y, torch.full_like(y, 0.9)], -1)
    return data.replace(mocap_pos=pos)

  def _ball_xy(self, data: Data) -> torch.Tensor:
    return data.qpos[:, self._ball_qadr:self._ball_qadr + 2]

  def _step_simulation(self, state: State, ctrl: torch.Tensor) -> State:
    state = super()._step_simulation(state, ctrl)
    keeper = opponents.step_keeper(
        state.info["keeper"], self._ball_xy(state.data), self.dt,
        goal_half_width=self._config["goal_half_width"])
    info = {**state.info, "keeper": keeper}
    data = self._place_mocap(state.data, info)
    # the goal flag sticks for the episode
    info["scored"] = torch.maximum(info["scored"],
                                   self._goal_scored(data, keeper))
    return state.replace(data=data, info=info)

  def _goal_scored(self, data: Data, keeper) -> torch.Tensor:
    cfg = self._config
    ball = self._ball_xy(data)
    in_goal_y = ball[:, 1].abs() < cfg["goal_half_width"]
    past_line = ball[:, 0] > cfg["goal_x"]
    # the keeper blocks a ball within its reach
    blocked = (ball[:, 1] - keeper.pose[:, 0]).abs() < cfg["keeper_reach"]
    return _f(past_line & in_goal_y & ~blocked)

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    qa, da = self._ball_qadr, self._ball_dadr
    return {"state": torch.cat([
        self._body_obs(data), data.qpos[:, qa:qa + 3],
        data.qvel[:, da:da + 3] * dt, info["keeper"].pose], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    goal = torch.tensor([self._config["goal_x"], 0.0], device=self.device)
    return {
        "goal_scored": info["scored"],
        "time_cost": torch.full_like(info["scored"], -1.0),
        "act_reg": -torch.mean(torch.square(data.act), -1),
        "pain": -self._fallen(data),
        "ball_dist": -_norm(self._ball_xy(data) - data.qpos[:, 0:2]),
        "goal_dist": -_norm(self._ball_xy(data) - goal),
    }

  def _get_done(self, state: State) -> torch.Tensor:
    return torch.maximum(self._fallen(state.data), state.info["scored"])

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    return {"solved": state.info["scored"], "score": state.info["scored"]}

  def _get_info(self, state: State) -> Dict:
    batch = state.reward.shape[0]
    fresh = self._new_keeper(state.info["generator"], batch)
    return _next_info(self, state, keeper=fresh,
                      scored=torch.zeros(batch, device=self.device))


class RunTrackEnv(_LegChallengeEnv):
  """Run down a track on the amputee leg: the OSL controller drives the
  prosthetic knee and ankle motors (the model's last two actuators) and
  the policy commands the muscles. Config keys beyond the walk's:
  min_velocity, finish_x, knee_qadr, knee_dadr, ankle_qadr, ankle_dadr,
  body_mass."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    self._knee_q, self._knee_d = int(c["knee_qadr"]), int(c["knee_dadr"])
    self._ankle_q, self._ankle_d = int(c["ankle_qadr"]), int(c["ankle_dadr"])
    self._osl_params = osl.make_osl_params(float(c["body_mass"]),
                                           device=model.device)

  @property
  def action_size(self) -> int:
    # the OSL's two motor commands are appended inside step
    return self._model.nu - 2

  def step(self, state: State, action: torch.Tensor) -> State:
    muscles = self.norm_actions(action)
    d = state.data
    # the prosthetic (right) side's load in Newtons: the thresholds were
    # scaled by the body mass
    load = self._grf(d)[:, 0] * self._body_weight
    phase, knee_tau, ankle_tau = osl.osl_step(
        state.info["osl_phase"], self._osl_params,
        d.qpos[:, self._knee_q], d.qvel[:, self._knee_d],
        d.qpos[:, self._ankle_q], d.qvel[:, self._ankle_d], load)
    ctrl = torch.cat([muscles, knee_tau[:, None], ankle_tau[:, None]], -1)
    state = state.replace(info={**state.info, "osl_phase": phase})
    return self.step_ctrl(state, ctrl)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    qpos = m.qpos0.expand(batch, -1).clone()
    if self._config.get("reset_type", "init") == "random":
      noise = _uniform(torch.rand(batch, m.nq, generator=generator,
                                  device=self.device), -0.02, 0.02)
      noise[:, :7] = 0.0
      qpos = qpos + noise
    qvel = torch.zeros(batch, m.nv, device=self.device)
    info = _fresh_info(self, generator, batch, osl_phase=torch.full(
        (batch,), osl.E_STANCE, dtype=torch.int32, device=self.device))
    data = self._make_data(qpos, qvel)
    zero = torch.zeros(batch, device=self.device)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero, "distance": zero},
                 info=info)

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    return {"state": self._body_obs(data)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    cfg = self._config
    vel = data.qvel[:, 0]
    fallen = self._fallen(data)
    upright = 1.0 - fallen
    return {"sparse": _f(vel > cfg["min_velocity"]) * upright,
            "solved": _f(data.qpos[:, 0] > cfg["finish_x"]) * upright,
            "act_reg": -torch.mean(torch.square(data.act), -1),
            "pain": -fallen,
            "vel_reward": torch.exp(
                -torch.square(vel - cfg["target_velocity"]) / 0.16)}

  def _get_done(self, state: State) -> torch.Tensor:
    finished = state.data.qpos[:, 0] > self._config["finish_x"]
    return torch.maximum(self._fallen(state.data), _f(finished))

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    return {"solved": rewards["solved"], "distance": state.data.qpos[:, 0]}

  def _get_info(self, state: State) -> Dict:
    phase = torch.full_like(state.info["osl_phase"], osl.E_STANCE)
    return _next_info(self, state, osl_phase=phase)


class RelocateEnv(MyoEnv):
  """Move an object from a pedestal to an in-air goal with the myoArm;
  the object's size, mass, inertia and friction are drawn per episode.
  Config keys: goal_center, goal_span, obj_scale_range, lift_th, drop_th,
  obj_site, obj_geom, obj_body, obj_qadr, obj_dadr."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    self._obj_site, self._obj_geom = int(c["obj_site"]), int(c["obj_geom"])
    self._obj_body = int(c["obj_body"])
    self._obj_qadr, self._obj_dadr = int(c["obj_qadr"]), int(c["obj_dadr"])
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=model.device)
    self._goal_center, self._goal_span = f32(c["goal_center"]), f32(
        c["goal_span"])

  def _model_for_step(self, info: Dict) -> Model:
    m = self._model
    s, mass = info["obj_scale"], info["obj_mass_scale"]
    fr = info["obj_friction_scale"]
    B, g, b = s.shape[0], self._obj_geom, self._obj_body
    size = m.geom_size.expand(B, -1, -1).clone()
    size[:, g] = m.geom_size[g] * s[:, None]
    friction = m.geom_friction.expand(B, -1, -1).clone()
    friction[:, g, 0] = m.geom_friction[g, 0] * fr
    body_mass = m.body_mass.expand(B, -1).clone()
    body_mass[:, b] = m.body_mass[b] * mass
    inertia = m.body_inertia.expand(B, -1, -1).clone()
    inertia[:, b] = m.body_inertia[b] * (mass * s * s)[:, None]
    return types.per_env_model(m, geom_size=size, geom_friction=friction,
                               body_mass=body_mass, body_inertia=inertia)

  def randomization_draws(self, generator: torch.Generator, batch: int):
    """(B, 6) uniforms on [0, 1): scale, mass, friction, goal xyz."""
    return torch.rand(batch, 6, generator=generator, device=self.device)

  def randomization_from_draws(self, u: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
    lo, hi = (float(x) for x in self._config["obj_scale_range"])
    span = self._goal_span
    return {"obj_scale": _uniform(u[:, 0], lo, hi),
            "obj_mass_scale": _uniform(u[:, 1], 0.5, 1.5),
            "obj_friction_scale": _uniform(u[:, 2], 0.7, 1.3),
            "goal_pos": self._goal_center + _uniform(u[:, 3:6], -span, span)}

  def _sample_randomization(self, generator: torch.Generator, batch: int):
    return self.randomization_from_draws(
        self.randomization_draws(generator, batch))

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    qpos = m.qpos0.expand(batch, -1).clone()
    qvel = torch.zeros(batch, m.nv, device=self.device)
    info = _fresh_info(self, generator, batch,
                       **self._sample_randomization(generator, batch))
    data = self._make_data(qpos, qvel)
    zero = torch.zeros(batch, device=self.device)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero}, info=info)

  def _pos_err(self, data: Data, info: Dict) -> torch.Tensor:
    return info["goal_pos"] - data.site_xpos[:, self._obj_site]

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    qa = self._obj_qadr
    return {"state": torch.cat([
        data.qpos[:, :qa], data.qvel[:, :self._obj_dadr] * dt, data.act,
        data.qpos[:, qa:qa + 3], data.qpos[:, qa + 3:qa + 7],
        info["goal_pos"], self._pos_err(data, info),
        torch.stack([info["obj_scale"], info["obj_mass_scale"],
                     info["obj_friction_scale"]], -1)], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dist = _norm(self._pos_err(data, info))
    lifted = data.site_xpos[:, self._obj_site, 2] > self._config["lift_th"]
    return {"pos_dist": -dist,
            "lift_bonus": 1.0 * _f(lifted),
            "bonus": 1.0 * _f(dist < 0.1) + 1.0 * _f(dist < 0.05),
            "act_reg": -torch.mean(torch.square(data.act), -1)}

  def _get_done(self, state: State) -> torch.Tensor:
    z = state.data.site_xpos[:, self._obj_site, 2]
    return _f(z < self._config["drop_th"])

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    dist = _norm(self._pos_err(state.data, state.info))
    return {"solved": _f(dist < 0.05)}

  def _get_info(self, state: State) -> Dict:
    fresh = self._sample_randomization(state.info["generator"],
                                       state.reward.shape[0])
    return _next_info(self, state, **fresh)


class BimanualEnv(MyoEnv):
  """Pass an object from a start pillar to a prosthetic gripper over a
  goal pillar. Config keys: proximity_th, drop_th, lift_th, goal_center,
  rpalm_site, obj_site, fin_sites, palm_body, obj_qadr, obj_dadr,
  pros_qadr, pros_dadr, obj_geom, and the geom groups of the touch
  channels touch_myo, touch_pros, touch_start, touch_goal, touch_env."""

  TOUCH = ("myo", "pros", "start", "goal", "env")

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    for k in ("rpalm_site", "obj_site", "palm_body", "obj_qadr", "obj_dadr",
              "pros_qadr", "pros_dadr"):
      setattr(self, "_" + k, int(c[k]))
    self._fin_sites = [int(s) for s in c["fin_sites"]]
    obj = int(c["obj_geom"])

    def obj_vs(group):
      ids = set(int(g) for g in group)
      return _slot_mask(model, lambda g1, g2: (g1 == obj and g2 in ids)
                        or (g2 == obj and g1 in ids))

    # (ncon_max, 5): the object's contacts with each group
    self._touch_masks = torch.stack(
        [obj_vs(c["touch_" + k]) for k in self.TOUCH], -1)
    # position actuators take a linear map onto their ctrlrange, muscles
    # the sigmoid
    self._robotic = torch.as_tensor(
        np.asarray(model.actuator_dyntype) != int(DynType.MUSCLE),
        device=model.device)
    self._goal_center = torch.as_tensor(c["goal_center"],
                                        dtype=torch.float32,
                                        device=model.device)

  def step(self, state: State, action: torch.Tensor) -> State:
    m = self._model
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    linear = 0.5 * (lo + hi) + action * 0.5 * (hi - lo)
    ctrl = torch.where(self._robotic, linear, self.norm_actions(action))
    return self.step_ctrl(state, ctrl)

  def shift_draws(self, generator: torch.Generator, batch: int):
    """(B, 2) uniforms on [0, 1) of a start or goal shift."""
    return torch.rand(batch, 2, generator=generator, device=self.device)

  def goal_from_draws(self, u: torch.Tensor) -> torch.Tensor:
    goal = self._goal_center.expand(u.shape[0], -1).clone()
    goal[:, :2] += _uniform(u, -0.05, 0.05)
    return goal

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    start = _uniform(self.shift_draws(generator, batch), -0.04, 0.04)
    goal = self.goal_from_draws(self.shift_draws(generator, batch))
    qpos = m.qpos0.expand(batch, -1).clone()
    qpos[:, self._obj_qadr:self._obj_qadr + 2] += start
    qvel = torch.zeros(batch, m.nv, device=self.device)
    info = _fresh_info(self, generator, batch, goal_pos=goal)
    data = self._make_data(qpos, qvel)
    zero = torch.zeros(batch, device=self.device)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero, "lifted": zero},
                 info=info)

  def _touching_body(self, data: Data) -> torch.Tensor:
    """(B, 5) contacts of the object with [myo, prosthesis, start, goal,
    env]."""
    return _f(data.contact_force > 0.0) @ self._touch_masks

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    pq, pd = self._pros_qadr, self._pros_dadr
    oq, od = self._obj_qadr, self._obj_dadr
    obj = data.site_xpos[:, self._obj_site]
    return {"state": torch.cat([
        data.time[:, None], data.qpos[:, :pq], data.qvel[:, :pd] * dt,
        data.qpos[:, pq:oq], data.qvel[:, pd:od] * dt,
        data.qpos[:, oq:oq + 7], data.qvel[:, od:od + 6] * dt,
        self._touching_body(data),
        data.xpos[:, self._palm_body] - obj,
        data.site_xpos[:, self._rpalm_site] - obj,
        info["goal_pos"] - obj, data.act], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    obj = data.site_xpos[:, self._obj_site]
    fin_dis = sum(_norm(data.site_xpos[:, s] - obj) for s in self._fin_sites)
    return {"reach_dist": _norm(data.xpos[:, self._palm_body] - obj),
            "act": _norm(data.act) / max(self._model.na, 1),
            "fin_dis": fin_dis,
            "pass_err": _norm(data.site_xpos[:, self._rpalm_site] - obj)}

  def _solved(self, data: Data, info: Dict) -> torch.Tensor:
    dist = _norm(data.site_xpos[:, self._obj_site] - info["goal_pos"])
    return _f(dist < self._config["proximity_th"])

  def _get_done(self, state: State) -> torch.Tensor:
    dropped = (state.data.site_xpos[:, self._obj_site, 2]
               < self._config["drop_th"])
    return torch.maximum(_f(dropped), self._solved(state.data, state.info))

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    z = state.data.site_xpos[:, self._obj_site, 2]
    return {"solved": self._solved(state.data, state.info),
            "lifted": _f(z > self._config["lift_th"])}

  def _get_info(self, state: State) -> Dict:
    goal = self.goal_from_draws(self.shift_draws(state.info["generator"],
                                                 state.reward.shape[0]))
    return _next_info(self, state, goal_pos=goal)


class TableTennisEnv(MyoEnv):
  """Return a served ball with a paddle welded to the myoArm's hand.
  Config keys: paddle_site, ball_site, palm_body, thorax_body, ball_qadr,
  ball_dadr, paddle_geom, table_geom, ball_geom."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    for k in ("paddle_site", "ball_site", "palm_body", "thorax_body",
              "ball_qadr", "ball_dadr"):
      setattr(self, "_" + k, int(c[k]))
    ball = int(c["ball_geom"])

    def pair_mask(a):
      return _slot_mask(model, lambda g1, g2: {g1, g2} == {a, ball})

    # (ncon_max, 2): paddle-ball, table-ball
    self._touch_masks = torch.stack([pair_mask(int(c["paddle_geom"])),
                                     pair_mask(int(c["table_geom"]))], -1)

  def launch_draws(self, generator: torch.Generator, batch: int):
    """(B, 3) uniforms on [0, 1) of a serve."""
    return torch.rand(batch, 3, generator=generator, device=self.device)

  @staticmethod
  def launch_from_draws(u: torch.Tensor):
    """Serve position and velocity toward the paddle's workspace."""
    y = 0.0 + _uniform(u[:, 0], -0.25, 0.25)
    pos = torch.stack([torch.full_like(y, -2.0), y,
                       torch.full_like(y, 1.25)], -1)
    vx = _uniform(u[:, 1], 2.4, 3.2)
    vy = -y * _uniform(u[:, 2], 0.3, 0.8)
    return pos, torch.stack([vx, vy, torch.full_like(y, 0.8)], -1)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    pos, vel = self.launch_from_draws(self.launch_draws(generator, batch))
    qpos = m.qpos0.expand(batch, -1).clone()
    qvel = torch.zeros(batch, m.nv, device=self.device)
    qpos[:, self._ball_qadr:self._ball_qadr + 3] = pos
    qvel[:, self._ball_dadr:self._ball_dadr + 3] = vel
    zero = torch.zeros(batch, device=self.device)
    info = _fresh_info(self, generator, batch, paddle_hit=zero)
    data = self._make_data(qpos, qvel)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero, "hit": zero},
                 info=info)

  def _ball_pos(self, data: Data) -> torch.Tensor:
    return data.qpos[:, self._ball_qadr:self._ball_qadr + 3]

  def _ball_vel(self, data: Data) -> torch.Tensor:
    return data.qvel[:, self._ball_dadr:self._ball_dadr + 3]

  def _touching(self, data: Data) -> torch.Tensor:
    """(B, 2) active paddle-ball and table-ball contacts."""
    return _f(data.contact_force > 0.0) @ self._touch_masks

  def _paddle_touch(self, data: Data) -> torch.Tensor:
    return _f(self._touching(data)[:, 0] > 0)

  def _step_simulation(self, state: State, ctrl: torch.Tensor) -> State:
    state = super()._step_simulation(state, ctrl)
    hit = torch.maximum(state.info["paddle_hit"],
                        self._paddle_touch(state.data))
    return state.replace(info={**state.info, "paddle_hit": hit})

  def _face(self, data: Data) -> torch.Tensor:
    """The paddle's face normal: its site frame's x axis."""
    return data.site_xmat[:, self._paddle_site, :, 0]

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    paddle = data.site_xpos[:, self._paddle_site]
    ball = self._ball_pos(data)
    return {"state": torch.cat([
        data.xpos[:, self._thorax_body], data.qpos[:, :self._ball_qadr],
        data.qvel[:, :self._ball_dadr] * dt, ball,
        self._ball_vel(data) * dt, paddle,
        data.cvel[:, self._palm_body] * dt, self._face(data), paddle - ball,
        self._touching(data), info["paddle_hit"][:, None], data.act], -1)}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    ball = self._ball_pos(data)
    reach = _norm(data.site_xpos[:, self._paddle_site] - ball)
    palm_d = _norm(data.xpos[:, self._palm_body] - ball)
    target = torch.tensor([-1.0, 0.0, 0.0], device=self.device)
    ori_err = _norm(self._face(data) - target)
    torso_err = data.qpos[:, 2].abs()
    return {"reach_dist": torch.exp(-1.0 * reach),
            "palm_dist": torch.exp(-5.0 * palm_d),
            "paddle_quat": torch.exp(-5.0 * ori_err),
            "torso_up": torch.exp(-5.0 * torso_err),
            "act_reg": -_norm(data.act) / max(self._model.na, 1),
            "sparse": self._paddle_touch(data),
            "solved": self._solved(data, info),
            "done_pen": -self._lost(data)}

  def _solved(self, data: Data, info: Dict) -> torch.Tensor:
    """A rally won: the ball returned over the net onto the far side."""
    ball, vel = self._ball_pos(data), self._ball_vel(data)
    returned = (ball[:, 0] < -1.4) & (vel[:, 0] < 0) & (ball[:, 2] > 0.86)
    return info["paddle_hit"] * _f(returned)

  def _lost(self, data: Data) -> torch.Tensor:
    ball = self._ball_pos(data)
    return _f((ball[:, 2] < 0.5) | (ball[:, 0] > 0.4))

  def _get_done(self, state: State) -> torch.Tensor:
    return torch.maximum(self._lost(state.data),
                         self._solved(state.data, state.info))

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    return {"solved": self._solved(state.data, state.info),
            "hit": state.info["paddle_hit"]}

  def _get_info(self, state: State) -> Dict:
    zero = torch.zeros_like(state.info["paddle_hit"])
    return _next_info(self, state, paddle_hit=zero)

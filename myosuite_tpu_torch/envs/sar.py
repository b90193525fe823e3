"""SAR multi-geometry in-hand reorientation (the JAX package's
ReorientSAREnv, ids MtxHandReorient{8,100,ID,OOD}-v0).

One capsule proxy on the pen scene is given per episode its own radius,
half-length and mass scale, drawn from a fixed per-variant geometry table
(`geometry_table`), and simulated through a per-env model
(`_model_for_step`): each env of a batch steps its own object, with no
host round trip. The 8 / 100 / ID / OOD variants differ in the table's
size and whether its rows fall inside the training range.

Behaviour: obs = hand joints, object position, object velocity, object
axis, goal axis, position error, axis error, act, muscle lengths,
velocities and forces, the geometry row; rewards pos_align, rot_align,
act_reg, drop, bonus; done when the object leaves the goal by 0.075;
solved when the axes align past 0.95 and the object is held. The geometry
row and goal axis are redrawn at every episode boundary.

Config keys (the pen scene's, `registry.task_config_from_npz`):
site_object_site, site_object_top, qadr_object_free, dadr_object_free,
goal_center, geom_variant, ctrl_dt, sim_dt, max_episode_steps,
reward_weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from myosuite_tpu_torch.envs.base import MyoEnv, State
from myosuite_tpu_torch.physics import types
from myosuite_tpu_torch.physics.types import Data, JointType, Model


def geometry_table(variant: str) -> np.ndarray:
  """(n, 3) rows of [radius, half_length, mass_scale] per variant, from a
  fixed seed (the JAX package's table, bit for bit)."""
  rng = np.random.RandomState(17)

  def rows(n, r_lo, r_hi, h_lo, h_hi):
    return np.stack([
        rng.uniform(r_lo, r_hi, n),
        rng.uniform(h_lo, h_hi, n),
        rng.uniform(0.6, 1.6, n)], axis=-1)

  if variant == "8":
    return rows(8, 0.008, 0.012, 0.050, 0.070)
  if variant == "100":
    return rows(100, 0.007, 0.014, 0.045, 0.080)
  if variant == "id":       # in-distribution eval: the training range
    return rows(100, 0.007, 0.014, 0.045, 0.080)
  if variant == "ood":      # out-of-distribution eval: outside it
    half = rows(50, 0.0045, 0.0068, 0.030, 0.044)
    big = rows(50, 0.0142, 0.018, 0.081, 0.095)
    return np.concatenate([half, big], axis=0)
  raise ValueError(variant)


# the goal's yaw / pitch draw: uniform in [-1, 1) x [-0.8, 1.2)
_GOAL_MIN = (-1.0, -0.8)
_GOAL_MAX = (1.0, 1.2)


def goal_dir_from_draws(u: torch.Tensor) -> torch.Tensor:
  """(B, 2) uniform draws on [0, 1) -> unit goal axes: yaw in +-pi, pitch
  in [-0.8, 1.2)."""
  lo = torch.tensor(_GOAL_MIN, dtype=torch.float32, device=u.device)
  hi = torch.tensor(_GOAL_MAX, dtype=torch.float32, device=u.device)
  v = u * (hi - lo) + lo
  yaw, pitch = v[:, 0] * math.pi, v[:, 1]
  return torch.stack([torch.cos(yaw) * torch.cos(pitch),
                      torch.sin(yaw) * torch.cos(pitch), torch.sin(pitch)],
                     -1)


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


class ReorientSAREnv(MyoEnv):
  """In-hand reorientation of a per-episode randomized capsule."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    self._obj_site = int(c["site_object_site"])
    self._top_site = int(c["site_object_top"])
    self._obj_qadr = int(c["qadr_object_free"])
    self._obj_dadr = int(c["dadr_object_free"])
    # the object's body is the free joint's, and its one geom the proxy
    jnt = [j for j in range(model.njnt)
           if int(model.jnt_qposadr[j]) == self._obj_qadr
           and int(model.jnt_type[j]) == JointType.FREE]
    assert len(jnt) == 1, jnt
    self._obj_body = int(model.jnt_bodyid[jnt[0]])
    geoms = np.nonzero(np.asarray(model.geom_bodyid) == self._obj_body)[0]
    assert len(geoms) == 1, geoms
    self._obj_geom = int(geoms[0])
    self._geoms = torch.as_tensor(geometry_table(c["geom_variant"]),
                                  dtype=torch.float32, device=model.device)
    self._center = torch.as_tensor(c["goal_center"], dtype=torch.float32,
                                   device=model.device)

  def _model_for_step(self, info: Dict) -> Model:
    m = self._model
    row = self._geoms[info["geom_idx"]]                    # (B, 3)
    B, g, b = row.shape[0], self._obj_geom, self._obj_body
    size = m.geom_size.expand(B, -1, -1).clone()
    size[:, g, 0] = row[:, 0]
    size[:, g, 1] = row[:, 1]
    mass = m.body_mass.expand(B, -1).clone()
    mass[:, b] = m.body_mass[b] * row[:, 2]
    inertia = m.body_inertia.expand(B, -1, -1).clone()
    inertia[:, b] = m.body_inertia[b] * row[:, 2:3]
    return types.per_env_model(m, geom_size=size, body_mass=mass,
                               body_inertia=inertia)

  def _sample_randomization(self, generator: torch.Generator,
                            batch: int) -> Dict[str, torch.Tensor]:
    idx = torch.randint(self._geoms.shape[0], (batch,), generator=generator,
                        device=self.device)
    u = torch.rand(batch, 2, generator=generator, device=self.device)
    return {"geom_idx": idx, "goal_dir": goal_dir_from_draws(u)}

  def reset(self, generator: torch.Generator, batch: int) -> State:
    m = self._model
    qpos = m.qpos0.expand(batch, -1).clone()
    qvel = torch.zeros(batch, m.nv, device=self.device)
    zero = torch.zeros(batch, device=self.device)
    info = {"generator": generator,
            "step_count": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device),
            "truncation": zero,
            **self._sample_randomization(generator, batch)}
    data = self._make_data(qpos, qvel)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={"solved": zero}, info=info)

  def _axes(self, data: Data, info: Dict):
    axis = data.site_xpos[:, self._top_site] - data.site_xpos[:,
                                                              self._obj_site]
    axis = axis / torch.clamp(_norm(axis), min=1e-9)[:, None]
    return axis, info["goal_dir"]

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    axis, goal = self._axes(data, info)
    obj_pos = data.site_xpos[:, self._obj_site]
    da = self._obj_dadr
    return {"state": torch.cat([
        data.qpos[:, :self._obj_qadr], obj_pos,
        data.qvel[:, da:da + 6] * dt, axis, goal, self._center - obj_pos,
        axis - goal, data.act, data.actuator_length,
        data.actuator_velocity * dt, data.actuator_force * 1e-3,
        self._geoms[info["geom_idx"]]], -1)}

  def _pos_align(self, data: Data) -> torch.Tensor:
    return _norm(self._center - data.site_xpos[:, self._obj_site])

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    axis, goal = self._axes(data, info)
    pos_align = self._pos_align(data)
    rot_align = (axis * goal).sum(-1)
    held = pos_align < 0.075
    f = lambda x: x.to(torch.float32)
    return {
        "pos_align": -pos_align,
        "rot_align": rot_align,
        "act_reg": -_norm(data.act) / max(self._model.na, 1),
        "drop": -1.0 * f(pos_align > 0.075),
        "bonus": (1.0 * f((rot_align > 0.9) & held)
                  + 5.0 * f((rot_align > 0.95) & held)),
    }

  def _get_done(self, state: State) -> torch.Tensor:
    return (self._pos_align(state.data) > 0.075).to(torch.float32)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    axis, goal = self._axes(state.data, state.info)
    return {"solved": (((axis * goal).sum(-1) > 0.95)
                       & (state.done == 0.0)).to(torch.float32)}

  def _get_info(self, state: State) -> Dict:
    truncation, boundary = self._episode_boundary(state)
    info = state.info
    fresh = self._sample_randomization(info["generator"],
                                       boundary.shape[0])
    out = {**info, "truncation": truncation,
           "step_count": torch.where(boundary,
                                     torch.zeros_like(info["step_count"]),
                                     info["step_count"])}
    for k, v in fresh.items():
      keep = info[k]
      out[k] = torch.where(boundary.view((-1,) + (1,) * (keep.dim() - 1)),
                           v, keep)
    return out

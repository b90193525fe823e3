"""Locomotion tasks on the myoLeg: walk, stand, walk over terrain.

Behaviour of the JAX package's WalkEnv, StandEnv and TerrainWalkEnv:
obs = [qpos without x, y; qvel * dt; root velocity; pelvis tilt; feet
heights; pelvis height; feet relative to the pelvis; gait phase (sin,
cos); tendon lengths, velocities * dt; actuator forces * 1e-3; act];
rewards vel_reward, done, cyclic_hip, ref_rot, joint_angle_rew, act_reg,
progress; done when the pelvis is below min_height or tilted beyond
max_rot. TerrainWalkEnv adds an egocentric 10 x 10 heightmap and draws a
terrain per env at each reset.

The site ids, hip qpos addresses and the two gait keyframes (which the JAX
package derives with host MuJoCo) come from the model file's config
(`registry.walk_config_from_npz`). Config keys: ctrl_dt, sim_dt,
max_episode_steps, target_velocity, gait_period, hip_amplitude,
min_height, max_rot, stand_height, reset_type ("none", "init" or
"random"), reward_weights, pelvis_site, torso_site, rfoot_site,
lfoot_site, rhip_adr, lhip_adr, gait_qpos (2, nq), gait_qvel (2, nv);
for terrain also terrain_type ("rough", "hilly", "stairs", "flat" or
"random"), hf_base and hf_extent.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from myosuite_tpu_torch.envs import heightfields
from myosuite_tpu_torch.envs.base import MyoEnv, State
from myosuite_tpu_torch.physics import math as pmath
from myosuite_tpu_torch.physics.types import Data, Model

_METRICS = ("vel_reward", "cyclic_hip", "ref_rot", "joint_angle_rew",
            "solved", "distance")


class WalkEnv(MyoEnv):
  """Muscle-driven bipedal walking at a target velocity."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    c = self._config
    self._pelvis_site = int(c["pelvis_site"])
    self._rfoot_site = int(c["rfoot_site"])
    self._lfoot_site = int(c["lfoot_site"])
    self._rhip_adr = int(c["rhip_adr"])
    self._lhip_adr = int(c["lhip_adr"])
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=model.device)
    self._gait_qpos = f32(c["gait_qpos"])
    self._gait_qvel = f32(c["gait_qvel"])

  def _reset_pose(self, generator: torch.Generator, batch: int):
    """(qpos, qvel) per reset_type: "none" stands still at qpos0; "init"
    starts from gait keyframe 0; "random" from a random keyframe plus qpos
    noise that leaves the height and root orientation exact."""
    m = self._model
    kind = self._config.get("reset_type", "init")
    if kind == "none":
      return (m.qpos0.expand(batch, -1).clone(),
              torch.zeros(batch, m.nv, device=self.device))
    if kind == "init":
      return (self._gait_qpos[0].expand(batch, -1).clone(),
              self._gait_qvel[0].expand(batch, -1).clone())
    k = (torch.rand(batch, generator=generator, device=self.device)
         < 0.5).long()
    noise = 0.02 * torch.randn(batch, m.nq, generator=generator,
                               device=self.device)
    noise[:, 2:7] = 0.0
    return self._gait_qpos[k] + noise, self._gait_qvel[k].clone()

  def _fresh_info(self, generator: torch.Generator, batch: int):
    return {"generator": generator,
            "step_count": torch.zeros(batch, dtype=torch.int32,
                                      device=self.device),
            "truncation": torch.zeros(batch, device=self.device)}

  def _initial_state(self, data: Data, info: Dict) -> State:
    zero = torch.zeros(data.batch, device=self.device)
    return State(data=data, obs=self._get_obs(data, info), reward=zero,
                 done=zero, metrics={k: zero for k in _METRICS}, info=info)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    qpos, qvel = self._reset_pose(generator, batch)
    return self._initial_state(self._make_data(qpos, qvel),
                               self._fresh_info(generator, batch))

  # -- gait quantities ------------------------------------------------------
  def _phase(self, data: Data) -> torch.Tensor:
    period = self._config["gait_period"]
    return torch.remainder(data.time, period) / period

  def _torso_angle(self, data: Data) -> torch.Tensor:
    """Pelvis tilt from upright as a rotation vector."""
    return pmath.quat_to_vel(pmath.normalize(data.qpos[:, 3:7]))

  def _com_vel(self, data: Data) -> torch.Tensor:
    return data.qvel[:, 0:3]

  def _root_yaw(self, data: Data) -> torch.Tensor:
    q = data.qpos[:, 3:7]
    return torch.atan2(2 * (q[:, 0] * q[:, 3] + q[:, 1] * q[:, 2]),
                       1 - 2 * (q[:, 2] ** 2 + q[:, 3] ** 2))

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    dt = self._config["sim_dt"]
    rfoot = data.site_xpos[:, self._rfoot_site]
    lfoot = data.site_xpos[:, self._lfoot_site]
    pelvis = data.site_xpos[:, self._pelvis_site]
    phase = 2 * math.pi * self._phase(data)
    obs = torch.cat([
        data.qpos[:, 2:],
        data.qvel * dt,
        self._com_vel(data),
        self._torso_angle(data),
        torch.stack([rfoot[:, 2], lfoot[:, 2]], -1),
        pelvis[:, 2:3],
        rfoot - pelvis,
        lfoot - pelvis,
        torch.stack([torch.sin(phase), torch.cos(phase)], -1),
        data.ten_length,
        data.ten_velocity * dt,
        data.actuator_force * 1e-3,
        data.act,
    ], -1)
    return {"state": obs}

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    cfg = self._config
    vel = self._com_vel(data)
    # two-gaussian velocity tracking; forward is +x, lateral +y
    vel_reward = (torch.exp(-torch.square(vel[:, 0] - cfg["target_velocity"]))
                  + torch.exp(-torch.square(vel[:, 1])))
    phase = 2 * math.pi * self._phase(data)
    amp = cfg["hip_amplitude"]
    r_target = amp * torch.cos(phase)
    l_target = amp * torch.cos(phase + math.pi)
    cyclic_hip = torch.sqrt(
        torch.square(data.qpos[:, self._rhip_adr] - r_target)
        + torch.square(data.qpos[:, self._lhip_adr] - l_target) + 1e-12)
    rot_mag = torch.linalg.vector_norm(self._torso_angle(data), dim=-1)
    ref_rot = torch.exp(-torch.square(rot_mag) / 0.1)
    jerr = torch.linalg.vector_norm(data.qpos[:, 7:] - self._model.qpos0[7:],
                                    dim=-1)
    joint_angle_rew = torch.exp(-torch.square(jerr) / 2.0)
    return {
        "vel_reward": vel_reward,
        "done": -1.0 * self._fallen(data),
        "cyclic_hip": cyclic_hip,
        "ref_rot": ref_rot,
        "joint_angle_rew": joint_angle_rew,
        "act_reg": -torch.mean(torch.square(data.act), -1),
        "progress": vel[:, 0],
    }

  def _pelvis_height(self, data: Data) -> torch.Tensor:
    return data.site_xpos[:, self._pelvis_site, 2]

  def _fallen(self, data: Data) -> torch.Tensor:
    rot = torch.linalg.vector_norm(self._torso_angle(data), dim=-1)
    return ((self._pelvis_height(data) < self._config["min_height"])
            | (rot > self._config["max_rot"])).to(torch.float32)

  def _get_done(self, state: State) -> torch.Tensor:
    return self._fallen(state.data)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    return {
        "vel_reward": rewards["vel_reward"],
        "cyclic_hip": rewards["cyclic_hip"],
        "ref_rot": rewards["ref_rot"],
        "joint_angle_rew": rewards["joint_angle_rew"],
        "solved": (rewards["vel_reward"] >= 1.0).to(torch.float32),
        "distance": state.data.qpos[:, 0],
    }

  def _get_info(self, state: State) -> Dict:
    truncation, boundary = self._episode_boundary(state)
    info = state.info
    step_count = torch.where(boundary, torch.zeros_like(info["step_count"]),
                             info["step_count"])
    return {**info, "truncation": truncation, "step_count": step_count}


class TerrainWalkEnv(WalkEnv):
  """Walking over procedural terrain, one terrain per env drawn at each
  reset, with an egocentric 10 x 10 heightmap in the obs."""

  def __init__(self, model: Model, config: Dict[str, Any]):
    super().__init__(model, config)
    if model.hfield_geomid < 0:
      raise ValueError("TerrainWalkEnv needs a model with a heightfield")
    self._hf_base = tuple(float(x) for x in config["hf_base"])
    self._hf_extent = tuple(float(x) for x in config["hf_extent"])
    self._hf_shape = (model.hfield_nrow, model.hfield_ncol)
    ncol = self._hf_shape[1]
    x = (self._hf_base[0] + (torch.arange(ncol, device=self.device)
                             / (ncol - 1) - 0.5) * self._hf_extent[0])
    # flat spawn pad: the terrain ramps in over [0.5 m, 2 m] ahead
    self._fade = torch.clamp((x - 0.5) / 1.5, 0.0, 1.0)

  def terrain(self, generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, nrow, ncol) terrain of this env's terrain_type ("random":
    rough, hilly or stairs per env)."""
    kind = self._config.get("terrain_type", "random")
    if kind == "random":
      codes = torch.randint(1, 4, (batch,), generator=generator,
                            device=self.device)
    else:
      code = int(heightfields.TerrainType[kind.upper()])
      codes = torch.full((batch,), code, device=self.device)
    hf = heightfields.generate(generator, codes, self._hf_shape)
    return hf * self._fade

  def reset(self, generator: torch.Generator, batch: int,
            hfield: Optional[torch.Tensor] = None) -> State:
    """A fresh batch; `hfield` (batch, nrow, ncol), when given, replaces
    the drawn terrain."""
    qpos, qvel = self._reset_pose(generator, batch)
    if hfield is None:
      hfield = self.terrain(generator, batch)
    return self._initial_state(self._make_data(qpos, qvel, hfield=hfield),
                               self._fresh_info(generator, batch))

  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    obs = super()._get_obs(data, info)
    hmap = heightfields.egocentric_heightmap(
        data.hfield_data, data.qpos[:, 0:2], self._root_yaw(data),
        self._hf_extent, base=self._hf_base)
    rel = hmap - data.qpos[:, 2, None, None]   # heights below the pelvis
    return {"state": torch.cat([obs["state"], rel.reshape(data.batch, -1)],
                               -1)}

  def _pelvis_height(self, data: Data) -> torch.Tensor:
    ground = heightfields.sample_height(data.hfield_data, data.qpos[:, 0:2],
                                        self._hf_extent, self._hf_base)
    return super()._pelvis_height(data) - ground


class StandEnv(WalkEnv):
  """Stand and balance: reach term 10 - |height error| - 0.1 |qvel|."""

  def _height_err(self, data: Data) -> torch.Tensor:
    return (self._pelvis_height(data) - self._config["stand_height"]).abs()

  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    height_err = self._height_err(data)
    vel_mag = torch.linalg.vector_norm(data.qvel, dim=-1)
    f = lambda x: x.to(torch.float32)
    return {
        "reach": 10.0 - height_err - 0.1 * vel_mag,
        "bonus": 1.0 * f(height_err < 0.1) + 1.0 * f(height_err < 0.05),
        "penalty": -1.0 * self._fallen(data),
        "act_reg": -torch.linalg.vector_norm(data.act, dim=-1),
    }

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]):
    zero = torch.zeros_like(rewards["reach"])
    return {"vel_reward": rewards["reach"], "cyclic_hip": zero,
            "ref_rot": zero, "joint_angle_rew": zero,
            "solved": (self._height_err(state.data) < 0.05).to(torch.float32),
            "distance": state.data.qpos[:, 0]}

"""Environment registry slice and `make`.

The port's envs load their model and task config from files committed in
`myosuite_tpu_torch/assets/`, compiled beforehand from MJCF, so `make`
needs no MuJoCo. Ids and aliases follow the JAX package's registry.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.physics import types

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
HAND_REACH_NPZ = os.path.join(ASSETS, "myohand_reach.npz")
ELBOW_NPZ = os.path.join(ASSETS, "myoelbow.npz")
FINGER_NPZ = os.path.join(ASSETS, "myofinger.npz")
LEG_NPZ = os.path.join(ASSETS, "myoleg.npz")
LEG_TERRAIN_NPZ = os.path.join(ASSETS, "myoleg_terrain.npz")
# the in-hand manipulation models, by object (envs/manipulation.py ENVS)
MANIP_NPZ = {obj: os.path.join(ASSETS, f"myohand_{obj}.npz")
             for obj in ("hold", "die", "pen", "baoding", "key")}

# order of the reward weights stored under "<prefix>reward_weights"
REACH_REWARDS = ("reach", "bonus", "penalty")
POSE_REWARDS = ("pose", "bonus", "act_reg", "penalty")

# The JAX package's pose-task defaults (its registry's base_env_config and
# pose_config), for the hand pose env, whose targets span the model's own
# joint ranges and which has no config of its own in a model file.
POSE_DEFAULTS = dict(
    ctrl_dt=0.02, sim_dt=0.002, max_episode_steps=100, norm_actions=True,
    reset_type="random", pose_thd=0.35, far_th=float(4 * np.pi / 2),
    fixed_target=False,
    reward_weights=dict(pose=1.0, bonus=4.0, act_reg=1.0, penalty=50.0))

# The walk task's scalar config keys, stored under "cfg_walk_<key>" (with
# the reward names and weights, site ids, hip addresses and gait keyframes;
# the terrain model adds hf_base and hf_extent).
WALK_SCALARS = ("ctrl_dt", "sim_dt", "max_episode_steps", "target_velocity",
                "gait_period", "hip_amplitude", "min_height", "max_rot",
                "stand_height")
WALK_IDS = ("pelvis_site", "torso_site", "rfoot_site", "lfoot_site",
            "rhip_adr", "lhip_adr")
# The JAX package's stand task: the walk config with these overrides.
STAND_OVERRIDES = dict(
    max_episode_steps=300, reset_type="none",
    reward_weights=dict(reach=1.0, bonus=4.0, penalty=50.0, act_reg=1.0))

_REGISTRY: Dict[str, Callable[..., Any]] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, factory: Callable[..., Any], aliases=()) -> None:
  _REGISTRY[name] = factory
  for a in aliases:
    _ALIASES[a] = name


def registered_envs():
  return sorted(_REGISTRY)


def resolve(name: str) -> str:
  return _ALIASES.get(name, name)


def make(name: str, device=None, overrides: Optional[Dict[str, Any]] = None):
  """Instantiate an env by id on `device` (default "cuda"; raises when CUDA
  is not available unless another device is named); `overrides` replace
  entries of the env's config."""
  name = resolve(name)
  if name not in _REGISTRY:
    raise KeyError(f"unknown env {name!r}; registered: {registered_envs()}")
  return _REGISTRY[name](types.resolve_device(device), dict(overrides or {}))


def _episode_config(extra: Dict[str, np.ndarray], p: str) -> Dict[str, Any]:
  return dict(ctrl_dt=float(extra[p + "ctrl_dt"]),
              sim_dt=float(extra[p + "sim_dt"]),
              max_episode_steps=int(extra[p + "max_episode_steps"]),
              far_th=float(extra[p + "far_th"]), norm_actions=True)


def reach_config_from_npz(extra: Dict[str, np.ndarray],
                          p: str = "cfg_") -> Dict[str, Any]:
  """ReachEnv config from the "<p>*" arrays of a model file."""
  return dict(
      _episode_config(extra, p),
      tip_sids=[int(s) for s in extra[p + "tip_sids"]],
      target_lo=extra[p + "target_lo"], target_hi=extra[p + "target_hi"],
      reward_weights=dict(zip(REACH_REWARDS,
                              map(float, extra[p + "reward_weights"]))))


def pose_config_from_npz(extra: Dict[str, np.ndarray],
                         p: str = "cfg_pose_") -> Dict[str, Any]:
  """PoseEnv config from the "<p>*" arrays of a model file."""
  return dict(
      _episode_config(extra, p),
      target_jnt_lo=extra[p + "target_jnt_lo"],
      target_jnt_hi=extra[p + "target_jnt_hi"],
      pose_thd=float(extra[p + "pose_thd"]),
      reset_type=str(extra[p + "reset_type"]),
      reward_weights=dict(zip(POSE_REWARDS,
                              map(float, extra[p + "reward_weights"]))))


def walk_config_from_npz(extra: Dict[str, np.ndarray],
                         p: str = "cfg_walk_") -> Dict[str, Any]:
  """WalkEnv config from the "<p>*" arrays of a model file."""
  cfg = {k: float(extra[p + k]) for k in WALK_SCALARS}
  cfg["max_episode_steps"] = int(cfg["max_episode_steps"])
  cfg.update({k: int(extra[p + k]) for k in WALK_IDS})
  cfg.update(
      norm_actions=True, reset_type=str(extra[p + "reset_type"]),
      reward_weights=dict(zip(map(str, extra[p + "reward_names"]),
                              map(float, extra[p + "reward_weights"]))),
      gait_qpos=extra[p + "gait_qpos"], gait_qvel=extra[p + "gait_qvel"])
  for k in ("hf_base", "hf_extent"):
    if p + k in extra:
      cfg[k] = tuple(map(float, extra[p + k]))
  return cfg


def manip_config_from_npz(extra: Dict[str, np.ndarray],
                          p: str = "cfg_manip_") -> Dict[str, Any]:
  """Manipulation env config from the "<p>*" arrays of a model file:
  integers (site ids, joint addresses, max_episode_steps) as int, other
  scalars as float, vectors as tuples, the reward names and weights as
  the ordered dict `reward_weights`."""
  cfg: Dict[str, Any] = dict(norm_actions=True)
  for key, v in extra.items():
    if not key.startswith(p) or key in (p + "reward_names",
                                        p + "reward_weights"):
      continue
    k = key[len(p):]
    if v.ndim:
      cfg[k] = tuple(map(float, v))
    elif np.issubdtype(v.dtype, np.integer):
      cfg[k] = int(v)
    else:
      cfg[k] = float(v)
  cfg["reward_weights"] = dict(zip(map(str, extra[p + "reward_names"]),
                                   map(float, extra[p + "reward_weights"])))
  return cfg


def _reach(path, prefix, device, overrides, fixed=False):
  from myosuite_tpu_torch.envs.reach import ReachEnv
  model, extra = physics_io.load_model(path, device)
  cfg = reach_config_from_npz(extra, prefix)
  cfg["fixed_target"] = fixed
  return ReachEnv(model, {**cfg, **overrides})


def _pose(path, device, overrides, fixed=False):
  from myosuite_tpu_torch.envs.pose import PoseEnv
  model, extra = physics_io.load_model(path, device)
  cfg = pose_config_from_npz(extra)
  cfg["fixed_target"] = fixed
  return PoseEnv(model, {**cfg, **overrides})


def _hand_pose(device, overrides, fixed=False):
  from myosuite_tpu_torch.envs.pose import PoseEnv
  model, _ = physics_io.load_model(HAND_REACH_NPZ, device)
  rng = model.jnt_range.cpu().numpy()
  cfg = dict(POSE_DEFAULTS, target_jnt_lo=rng[:, 0], target_jnt_hi=rng[:, 1],
             pose_thd=1.0, fixed_target=fixed)
  return PoseEnv(model, {**cfg, **overrides})


def _leg(device, overrides, kind="walk"):
  """The myoLeg tasks: "walk", "stand", or a terrain type for walking over
  terrain ("rough", "hilly", "stairs", "flat", "random")."""
  from myosuite_tpu_torch.envs import locomotion
  terrain = kind not in ("walk", "stand")
  model, extra = physics_io.load_model(
      LEG_TERRAIN_NPZ if terrain else LEG_NPZ, device)
  cfg = walk_config_from_npz(extra)
  if kind == "stand":
    return locomotion.StandEnv(model, {**cfg, **STAND_OVERRIDES, **overrides})
  if terrain:
    return locomotion.TerrainWalkEnv(
        model, {**cfg, "terrain_type": kind, **overrides})
  return locomotion.WalkEnv(model, {**cfg, **overrides})


def _manip(obj, device, overrides, fixed=False):
  """The in-hand manipulation task of the model file of `obj`."""
  from myosuite_tpu_torch.envs import manipulation
  model, extra = physics_io.load_model(MANIP_NPZ[obj], device)
  cfg = dict(manip_config_from_npz(extra), fixed_target=fixed)
  return manipulation.ENVS[obj](model, {**cfg, **overrides})


def _register_pair(stem, factory, aliases):
  """<stem>{Random,Fixed}-v0 and their aliases (each an alias stem)."""
  for kind, fixed in (("Random", False), ("Fixed", True)):
    register(f"{stem}{kind}-v0", functools.partial(factory, fixed=fixed),
             aliases=tuple(f"{a}{kind}-v0" for a in aliases))


_register_pair("MtxHandReach",
               functools.partial(_reach, HAND_REACH_NPZ, "cfg_"),
               ("MjxHandReach", "myoHandReach"))
_register_pair("MtxElbowPose", functools.partial(_pose, ELBOW_NPZ),
               ("MjxElbowPose", "myoElbowPose1D6M"))
_register_pair("MtxFingerPose", functools.partial(_pose, FINGER_NPZ),
               ("MjxFingerPose", "myoFingerPose"))
_register_pair("MtxFingerReach",
               functools.partial(_reach, FINGER_NPZ, "cfg_reach_"),
               ("myoFingerReach",))
_register_pair("MtxHandPose", _hand_pose, ("MjxHandPose", "myoHandPose"))
register("MtxLegWalk-v0", _leg, aliases=("myoLegWalk-v0",))
register("MtxLegStand-v0", functools.partial(_leg, kind="stand"),
         aliases=("myoLegReachFixed-v0", "myoLegStand-v0"))
for _kind, _alias in (("Rough", "Rough"), ("Hilly", "Hilly"),
                      ("Stairs", "Stair")):
  register(f"MtxLegWalk{_kind}-v0", functools.partial(_leg,
                                                      kind=_kind.lower()),
           aliases=(f"myoLeg{_alias}TerrainWalk-v0",))
_register_pair("MtxHandObjHold", functools.partial(_manip, "hold"),
               ("myoHandObjHold",))
register("MtxHandDieReorient-v0", functools.partial(_manip, "die"),
         aliases=("myoChallengeDieReorientP1-v0", "myoHandReorient-v0"))
_register_pair("MtxHandPenTwirl", functools.partial(_manip, "pen"),
               ("myoHandPenTwirl",))
register("MtxHandBaoding-v0", functools.partial(_manip, "baoding"),
         aliases=("myoChallengeBaodingP1-v1", "myoHandBaodingRandom-v0"))
_register_pair("MtxHandKeyTurn", functools.partial(_manip, "key"),
               ("myoHandKeyTurn",))

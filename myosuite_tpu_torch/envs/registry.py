"""Environment registry slice and `make`.

The port's envs load their model and task config from files committed in
`myosuite_tpu_torch/assets/`, compiled beforehand from MJCF, so `make`
needs no MuJoCo. Ids and aliases follow the JAX package's registry.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict

import numpy as np

from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.physics import types

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
HAND_REACH_NPZ = os.path.join(ASSETS, "myohand_reach.npz")

# order of the reward weights stored under "cfg_reward_weights"
REACH_REWARDS = ("reach", "bonus", "penalty")

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


def make(name: str, device=None):
  """Instantiate an env by id on `device` (default "cuda"; raises when CUDA
  is not available unless another device is named)."""
  name = resolve(name)
  if name not in _REGISTRY:
    raise KeyError(f"unknown env {name!r}; registered: {registered_envs()}")
  return _REGISTRY[name](types.resolve_device(device))


def reach_config_from_npz(extra: Dict[str, np.ndarray]) -> Dict[str, Any]:
  """ReachEnv config from the "cfg_*" arrays of a model file."""
  return dict(
      tip_sids=[int(s) for s in extra["cfg_tip_sids"]],
      target_lo=extra["cfg_target_lo"], target_hi=extra["cfg_target_hi"],
      ctrl_dt=float(extra["cfg_ctrl_dt"]), sim_dt=float(extra["cfg_sim_dt"]),
      max_episode_steps=int(extra["cfg_max_episode_steps"]),
      far_th=float(extra["cfg_far_th"]), norm_actions=True,
      reward_weights=dict(zip(REACH_REWARDS,
                              map(float, extra["cfg_reward_weights"]))))


def _hand_reach(device, fixed=False):
  from myosuite_tpu_torch.envs.reach import ReachEnv
  model, extra = physics_io.load_model(HAND_REACH_NPZ, device)
  cfg = reach_config_from_npz(extra)
  cfg["fixed_target"] = fixed
  return ReachEnv(model, cfg)


register("MtxHandReachRandom-v0", _hand_reach,
         aliases=("MjxHandReachRandom-v0", "myoHandReachRandom-v0"))
register("MtxHandReachFixed-v0", functools.partial(_hand_reach, fixed=True),
         aliases=("MjxHandReachFixed-v0", "myoHandReachFixed-v0"))

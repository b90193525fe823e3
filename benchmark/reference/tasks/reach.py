"""MyoSuite's hand reach (`myoHandReachRandom-v0`): the task config stored
in the model file under "cfg_", random targets."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.reference.envs.reach import ReachEnv

REWARDS = ("reach", "bonus", "penalty")


def config(extra: Dict[str, np.ndarray], p: str = "cfg_") -> Dict[str, Any]:
  return dict(
      ctrl_dt=float(extra[p + "ctrl_dt"]), sim_dt=float(extra[p + "sim_dt"]),
      max_episode_steps=int(extra[p + "max_episode_steps"]),
      far_th=float(extra[p + "far_th"]), norm_actions=True,
      tip_sids=[int(s) for s in extra[p + "tip_sids"]],
      target_lo=extra[p + "target_lo"], target_hi=extra[p + "target_hi"],
      reward_weights=dict(zip(REWARDS,
                              map(float, extra[p + "reward_weights"]))),
      fixed_target=False)


def make(model, extra: Dict[str, np.ndarray]):
  return ReachEnv(model, config(extra))

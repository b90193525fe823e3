"""MyoChallenge 2022's die reorientation (`myoChallengeDieReorientP1-v0`):
the task config stored in the model file under "cfg_manip_", random goal
orientations."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.reference.envs.manipulation import ReorientEnv


def config(extra: Dict[str, np.ndarray], p: str = "cfg_manip_"
           ) -> Dict[str, Any]:
  """Every "<p><key>" array as the key's value (scalars and tuples), and
  the reward weights by name."""
  cfg: Dict[str, Any] = dict(norm_actions=True, fixed_target=False)
  for key, v in extra.items():
    if not key.startswith(p) or key in (p + "reward_names",
                                        p + "reward_weights"):
      continue
    k = key[len(p):]
    if v.dtype.kind in "US":
      cfg[k] = str(v)
    elif np.issubdtype(v.dtype, np.integer):
      cfg[k] = tuple(map(int, v)) if v.ndim else int(v)
    else:
      cfg[k] = tuple(map(float, v)) if v.ndim else float(v)
  cfg["reward_weights"] = dict(zip(map(str, extra[p + "reward_names"]),
                                   map(float, extra[p + "reward_weights"])))
  return cfg


def make(model, extra: Dict[str, np.ndarray]):
  return ReorientEnv(model, config(extra))

"""RoboSet-schema traces (the JAX package's `logger.roboset`): per-trial
groups "Trial<N>" holding `data/...` streams (time, qpos, qvel, ctrl,
observations, rewards) and `env_infos/...` streams (solved, done)."""

from __future__ import annotations

import numpy as np

from myosuite_tpu_torch.logger.trace import Trace, to_numpy


class RoboSetTrace(Trace):
  """A Trace in the RoboSet layout."""

  DATA_KEYS = ("time", "qpos", "qvel", "ctrl", "observations", "rewards")
  INFO_KEYS = ("solved", "done")

  def append_step(self, trial: int, *, time, qpos, qvel, ctrl, observations,
                  rewards, solved=0.0, done=0.0) -> None:
    group = f"Trial{trial}"
    if group not in self.trace:
      self.create_group(group)
    vals = dict(time=time, qpos=qpos, qvel=qvel, ctrl=ctrl,
                observations=observations, rewards=rewards)
    for k, v in vals.items():
      self.append_datum(group, f"data/{k}", to_numpy(v))
    self.append_datum(group, "env_infos/solved", to_numpy(solved))
    self.append_datum(group, "env_infos/done", to_numpy(done))

  @classmethod
  def from_paths(cls, paths, name: str = "RoboSet") -> "RoboSetTrace":
    """examine_env-style paths ({"obs", "reward"[, "solved"]} each) as
    RoboSet trials."""
    tr = cls(name)
    for i, p in enumerate(paths):
      group = f"Trial{i}"
      tr.create_group(group)
      obs = (np.stack([to_numpy(o) for o in p["obs"]])
             if isinstance(p["obs"], list) else to_numpy(p["obs"]))
      rew = to_numpy(p["reward"])
      tr.trace[group]["data/observations"] = obs
      tr.trace[group]["data/rewards"] = rew
      tr.trace[group]["data/time"] = np.arange(len(rew), dtype=np.float32)
      if "solved" in p:
        tr.trace[group]["env_infos/solved"] = to_numpy(p["solved"])
    return tr

"""Rollout path utilities: stats, plots, format conversion (the JAX
package's `utils/paths_utils.py`, over the port's `logger.trace` and
`logger.roboset`).

Role-equivalent of the reference's paths_utils
(MyoSuite's myosuite/utils/paths_utils.py:22-473): horizon/return
summaries, 2D obs/action plots (matplotlib optional), pickle<->h5 Trace
conversion, and RoboSet schema packing. Paths follow the examine_env
convention: list of dicts with "obs"/"reward"/"solved" streams, each a
tensor on any device, an array or a list of per-step values. Stats,
plots and traces read them on the host; `truncate_paths` slices them
where they lie.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from myosuite_tpu_torch.logger.trace import to_numpy


def _host(v) -> np.ndarray:
  """A stream (a tensor, an array or a list of per-step values) as one
  numpy array."""
  if isinstance(v, list):
    return np.stack([to_numpy(x) for x in v]) if v else np.zeros(0)
  return to_numpy(v)


def path_stats(paths: List[Dict]) -> Dict[str, float]:
  """Horizon / return / success summary over a list of paths."""
  horizons = [len(p["reward"]) for p in paths]
  returns = [float(np.sum(_host(p["reward"]))) for p in paths]
  solved = [float(np.sum(_host(p.get("solved", [0.0])))) for p in paths]
  return {
      "num_paths": len(paths),
      "horizon_mean": float(np.mean(horizons)) if horizons else 0.0,
      "horizon_min": float(np.min(horizons)) if horizons else 0.0,
      "horizon_max": float(np.max(horizons)) if horizons else 0.0,
      "return_mean": float(np.mean(returns)) if returns else 0.0,
      "return_std": float(np.std(returns)) if returns else 0.0,
      # success = solved held for > 5 steps (env_base.py:798-824 semantics)
      "success_rate": float(np.mean([s > 5 for s in solved])) if solved
      else 0.0,
  }


def plot_horizon(paths: List[Dict], fileName_prefix: str = "paths") -> str:
  """Histogram of episode horizons (reference plot_horizon role)."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  horizons = [len(p["reward"]) for p in paths]
  fig, ax = plt.subplots()
  ax.hist(horizons, bins=min(20, max(len(set(horizons)), 1)))
  ax.set_xlabel("horizon")
  ax.set_ylabel("count")
  out = f"{fileName_prefix}_horizon.pdf"
  fig.savefig(out)
  plt.close(fig)
  return out


def plot_obs_actions(paths: List[Dict], fileName_prefix: str = "paths",
                     max_dims: int = 16) -> str:
  """Per-dimension obs (and action, if logged) time series plots
  (reference plot() role, paths_utils.py 2D plots)."""
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  obs = _host(paths[0]["obs"])
  nd = min(obs.shape[-1], max_dims)
  fig, axes = plt.subplots(nd, 1, figsize=(8, 1.2 * nd), sharex=True)
  axes = np.atleast_1d(axes)
  for p in paths:
    o = _host(p["obs"])
    for d in range(nd):
      axes[d].plot(o[:, d], alpha=0.6, lw=0.8)
  for d in range(nd):
    axes[d].set_ylabel(f"obs[{d}]", fontsize=6)
  out = f"{fileName_prefix}_obs.pdf"
  fig.savefig(out)
  plt.close(fig)
  return out


def paths_to_trace(paths: List[Dict], name: str = "rollouts"):
  """Pack paths into a Trace (h5-serializable)."""
  from myosuite_tpu_torch.logger.trace import Trace

  tr = Trace(name)
  for i, p in enumerate(paths):
    group = f"rollout{i}"
    tr.create_group(group)
    for k, v in p.items():
      if k == "data" or (isinstance(v, list) and not v):
        continue
      tr.trace[group][k] = _host(v)
  return tr


def pickle2h5(pickle_path: str, h5_path: Optional[str] = None,
              verify: bool = True) -> str:
  """Convert a pickled Trace/paths file to gzip'd h5
  (reference pickle2h5 role)."""
  import pickle

  from myosuite_tpu_torch.logger.trace import Trace

  with open(pickle_path, "rb") as f:
    payload = pickle.load(f)
  h5_path = h5_path or pickle_path.rsplit(".", 1)[0] + ".h5"
  if isinstance(payload, list):          # paths
    tr = paths_to_trace(payload)
  elif isinstance(payload, dict):        # Trace.root
    tr = Trace(next(iter(payload)))
    tr.root = payload
    tr.trace = payload[tr.name]
  else:
    raise TypeError(f"unsupported pickle payload: {type(payload)}")
  tr.save(h5_path)
  if verify:
    Trace.load(h5_path)
  return h5_path


def paths_to_roboset(paths: List[Dict], h5_path: str) -> str:
  """Emit paths in the RoboSet schema (reference path2dataset role)."""
  from myosuite_tpu_torch.logger.roboset import RoboSetTrace

  tr = RoboSetTrace.from_paths(paths)
  tr.save(h5_path)
  return h5_path


def truncate_paths(paths: List[Dict], horizon: int) -> List[Dict]:
  """Clip every stream to `horizon` steps (reference truncate_paths,
  env_base.py:782-796)."""
  out = []
  for p in paths:
    out.append({k: (v[:horizon] if hasattr(v, "__len__") else v)
                for k, v in p.items()})
  return out

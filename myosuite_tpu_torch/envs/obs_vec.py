"""Ordered obs-dict <-> flat vector codec.

The JAX package's `ObsVec` on tensors: a fixed key ordering defines the
observation vector's layout, and the codec exposes the index map so that
the same reward code runs per step and batched over (traj, horizon) paths.
`obsdict2obsvec` ravels every key whole (a batched entry too), as the JAX
version does; `obsvec2obsdict` keeps any leading batch dims.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


class ObsVec:
  """Codec fixed at construction from a template obs_dict."""

  def __init__(self, obs_keys: Sequence[str],
               template: Dict[str, torch.Tensor]):
    self.obs_keys: List[str] = list(obs_keys)
    self._slices: List[Tuple[str, int, int, tuple]] = []
    off = 0
    for k in self.obs_keys:
      shape = tuple(np.shape(template[k]))
      n = int(np.prod(shape)) if shape else 1
      self._slices.append((k, off, off + n, shape))
      off += n
    self.size = off

  def obsdict2obsvec(self, obs_dict: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """Concatenate the ordered keys into one flat float32 vector."""
    parts = [torch.as_tensor(obs_dict[k], dtype=torch.float32).reshape(-1)
             for k in self.obs_keys]
    return torch.cat(parts) if parts else torch.zeros(0)

  def obsvec2obsdict(self, obsvec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split a (..., size) vector back into the keyed dict; leading batch
    dims are kept (the (traj, horizon, obs) pattern)."""
    out = {}
    for k, lo, hi, shape in self._slices:
      seg = obsvec[..., lo:hi]
      out[k] = seg.reshape(obsvec.shape[:-1] + (shape if shape else (1,)))
    return out

  def index_map(self) -> Dict[str, Tuple[int, int]]:
    return {k: (lo, hi) for k, lo, hi, _ in self._slices}


def compute_path_rewards(obsvec_paths: torch.Tensor, codec: ObsVec,
                         reward_fn) -> Dict[str, torch.Tensor]:
  """Reward terms recomputed over (num_traj, horizon, obs_dim) paths:
  `reward_fn` maps an obs_dict of batched entries to a dict of terms."""
  return reward_fn(codec.obsvec2obsdict(obsvec_paths))


def evaluate_success(solved_paths: Sequence, min_solved_steps: int = 5
                     ) -> float:
  """Success in percent over paths: an episode succeeds when `solved`
  holds for more than `min_solved_steps` steps."""
  if not len(solved_paths):
    return 0.0
  wins = [float(np.sum(_numpy(s) > 0) > min_solved_steps)
          for s in solved_paths]
  return 100.0 * float(np.mean(wins))


def _numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)

"""Weights across the two packages: flax PPO parameters <-> state dicts.

The JAX package's `PolicyNet` and `ValueNet` each hold one flax `MLP`
(scope "MLP_0") of Dense layers "dense_0" .. "dense_{n-2}" and "out", with
a kernel of shape (in, out). The port's networks hold `mlp.layers.i`, an
`nn.Linear` whose weight is (out, in). Everything here is numpy on one
side and torch on the other, so the port never imports flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from myosuite_tpu_torch.train import running_stats


def _mlp_scope(params: Mapping[str, Any]) -> Mapping[str, Any]:
  if "params" in params:
    params = params["params"]
  return params["MLP_0"]


def state_dict_from_flax(params: Mapping[str, Any], device=None
                         ) -> Dict[str, torch.Tensor]:
  """A flax PolicyNet / ValueNet parameter tree (numpy leaves, with or
  without the top-level "params") as the port network's state dict."""
  mlp = _mlp_scope(params)
  names = sorted((k for k in mlp if k.startswith("dense_")),
                 key=lambda k: int(k.split("_")[1])) + ["out"]
  if set(names) != set(mlp):
    raise ValueError(f"unexpected layers in the flax MLP: {sorted(mlp)}")
  out = {}
  for i, name in enumerate(names):
    kernel = np.asarray(mlp[name]["kernel"], dtype=np.float32)
    bias = np.asarray(mlp[name]["bias"], dtype=np.float32)
    out[f"mlp.layers.{i}.weight"] = torch.tensor(kernel.T.copy(),
                                                 device=device)
    out[f"mlp.layers.{i}.bias"] = torch.tensor(bias, device=device)
  return out


def flax_from_state_dict(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
  """The reverse: a port network's state dict as a flax parameter tree
  {"params": {"MLP_0": {...}}} of numpy arrays."""
  n = len(state) // 2
  mlp = {}
  for i in range(n):
    name = "out" if i == n - 1 else f"dense_{i}"
    w = state[f"mlp.layers.{i}.weight"].detach().cpu().numpy()
    mlp[name] = {"kernel": np.ascontiguousarray(w.T),
                 "bias": state[f"mlp.layers.{i}.bias"].detach().cpu().numpy()}
  return {"params": {"MLP_0": mlp}}


def running_stats_from_flax(stats: Any, device=None
                            ) -> running_stats.RunningStats:
  """The JAX package's RunningStats (any object with count, mean, m2 as
  arrays) as the port's."""
  f32 = lambda x: torch.tensor(np.asarray(x, dtype=np.float32),
                               device=device)
  return running_stats.RunningStats(count=f32(stats.count),
                                    mean=f32(stats.mean), m2=f32(stats.m2))


def running_stats_to_numpy(stats: running_stats.RunningStats
                           ) -> Dict[str, np.ndarray]:
  """The port's RunningStats as numpy count / mean / m2, the fields of the
  JAX package's RunningStats."""
  return {k: getattr(stats, k).detach().cpu().numpy()
          for k in ("count", "mean", "m2")}

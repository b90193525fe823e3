"""Weights and optimizer states across the two packages.

The JAX package's `PolicyNet` and `ValueNet` each hold one flax `MLP`
(scope "MLP_0") of Dense layers "dense_0" .. "dense_{n-2}" and "out", with
a kernel of shape (in, out); SAC's `QNet` holds "q{j}_dense_{i}" and
"q{j}_out" for its two critics. The port's networks hold `nn.Linear`
layers whose weight is (out, in). The optax states of PPO's chain and of
a plain Adam map onto `ppo.OptState` and `ppo.AdamState`. Everything here
is numpy on one side and torch on the other, so the port never imports
flax or optax.
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


def _dense_names(scope: Mapping[str, Any], prefix: str, out: str
                 ) -> list:
  """A flax MLP's Dense layer names in order: "<prefix>0", "<prefix>1",
  ..., then `out`."""
  return sorted((k for k in scope if k.startswith(prefix)),
                key=lambda k: int(k[len(prefix):])) + [out]


def _to_linear(scope: Mapping[str, Any], names, prefix: str, device
               ) -> Dict[str, torch.Tensor]:
  """The Dense layers `names` of a flax scope as `<prefix>{i}.weight` /
  `.bias` of nn.Linear layers (kernels transposed)."""
  out = {}
  for i, name in enumerate(names):
    kernel = np.asarray(scope[name]["kernel"], dtype=np.float32)
    bias = np.asarray(scope[name]["bias"], dtype=np.float32)
    out[f"{prefix}{i}.weight"] = torch.tensor(kernel.T.copy(), device=device)
    out[f"{prefix}{i}.bias"] = torch.tensor(bias, device=device)
  return out


def _to_dense(state: Mapping[str, torch.Tensor], prefix: str, dense: str,
              out: str) -> Dict[str, Any]:
  """The reverse of `_to_linear`: the nn.Linear layers `<prefix>{i}` of a
  state dict as Dense layers "<dense>{i}" and, the last, `out`."""
  n = sum(1 for k in state if k.startswith(prefix)) // 2
  tree = {}
  for i in range(n):
    w = state[f"{prefix}{i}.weight"].detach().cpu().numpy()
    tree[out if i == n - 1 else f"{dense}{i}"] = {
        "kernel": np.ascontiguousarray(w.T),
        "bias": state[f"{prefix}{i}.bias"].detach().cpu().numpy()}
  return tree


def state_dict_from_flax(params: Mapping[str, Any], device=None
                         ) -> Dict[str, torch.Tensor]:
  """A flax PolicyNet / ValueNet parameter tree (numpy leaves, with or
  without the top-level "params") as the port network's state dict."""
  mlp = _mlp_scope(params)
  names = _dense_names(mlp, "dense_", "out")
  if set(names) != set(mlp):
    raise ValueError(f"unexpected layers in the flax MLP: {sorted(mlp)}")
  return _to_linear(mlp, names, "mlp.layers.", device)


def flax_from_state_dict(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
  """The reverse: a port network's state dict as a flax parameter tree
  {"params": {"MLP_0": {...}}} of numpy arrays."""
  return {"params": {"MLP_0": _to_dense(state, "mlp.layers.", "dense_",
                                        "out")}}


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


# -- SAC's twin critics ------------------------------------------------------

def q_state_dict_from_flax(params: Mapping[str, Any], device=None
                           ) -> Dict[str, torch.Tensor]:
  """A flax `QNet` parameter tree (Dense layers "q{j}_dense_{i}" and
  "q{j}_out", with or without the top-level "params") as the state dict
  of the port's `sac.QNet` (`critics.{j}.layers.{i}`)."""
  if "params" in params:
    params = params["params"]
  out, used = {}, set()
  for j in range(2):
    names = _dense_names(params, f"q{j}_dense_", f"q{j}_out")
    used.update(names)
    out.update(_to_linear(params, names, f"critics.{j}.layers.", device))
  if used != set(params):
    raise ValueError(f"unexpected layers in the flax QNet: {sorted(params)}")
  return out


def flax_q_from_state_dict(state: Mapping[str, torch.Tensor]
                           ) -> Dict[str, Any]:
  """The reverse: a `sac.QNet` state dict as {"params": {"q{j}_...": ...}}
  of numpy arrays."""
  tree = {}
  for j in range(2):
    tree.update(_to_dense(state, f"critics.{j}.layers.", f"q{j}_dense_",
                          f"q{j}_out"))
  return {"params": tree}


# -- optimizer states --------------------------------------------------------

def _adam_part(inner: Any) -> Any:
  """optax's ScaleByAdamState (count, mu, nu) inside a chain's state."""
  if hasattr(inner, "mu") and hasattr(inner, "nu"):
    return inner
  if isinstance(inner, Mapping):
    inner = list(inner.values())
  if isinstance(inner, (list, tuple)):
    for x in inner:
      found = _adam_part(x)
      if found is not None:
        return found
  return None


def _flat_moment(trees, to_state_dict, device) -> torch.Tensor:
  """Moments in the flax trees `trees` as one vector in the order of the
  port's state dicts (kernels transposed)."""
  return torch.cat([v.reshape(-1) for tree in trees
                    for v in to_state_dict(tree, device).values()])


def opt_state_from_optax(opt_state: Any, device=None):
  """The state of the JAX PPO's apply_if_finite(chain(clip_by_global_norm,
  adam)) over (policy params, value params) as the port's `ppo.OptState`:
  Adam's count (also the lr schedule's), mu and nu flat in the order of
  `PPO.flat_params`, and the three non-finite counters."""
  from myosuite_tpu_torch.train import ppo
  adam = _adam_part(opt_state.inner_state)
  if adam is None:
    raise ValueError("no Adam state in the optax state")
  i32 = lambda x: torch.tensor(np.asarray(x, dtype=np.int32), device=device)
  return ppo.OptState(
      count=i32(adam.count),
      mu=[_flat_moment(adam.mu, state_dict_from_flax, device)],
      nu=[_flat_moment(adam.nu, state_dict_from_flax, device)],
      notfinite_count=i32(opt_state.notfinite_count),
      last_finite=torch.tensor(bool(np.asarray(opt_state.last_finite)),
                               device=device),
      total_notfinite=i32(opt_state.total_notfinite))


def adam_state_from_optax(opt_state: Any, to_state_dict=None, device=None):
  """A plain optax.adam state over one parameter tree as the port's
  `ppo.AdamState` (mu and nu flat in the order of the port's state dict;
  `to_state_dict` maps a tree to it, `state_dict_from_flax` by default, a
  scalar tree such as SAC's log_alpha stays a scalar)."""
  from myosuite_tpu_torch.train import ppo
  adam = _adam_part(opt_state)
  if adam is None:
    raise ValueError("no Adam state in the optax state")
  to_state_dict = to_state_dict or state_dict_from_flax
  if np.ndim(adam.mu) == 0 and not isinstance(adam.mu, Mapping):
    moment = lambda m: [torch.tensor(np.float32(m), device=device)]
  else:
    moment = lambda m: [_flat_moment([m], to_state_dict, device)]
  return ppo.AdamState(
      count=torch.tensor(np.asarray(adam.count, dtype=np.int32),
                         device=device),
      mu=moment(adam.mu), nu=moment(adam.nu))


def optax_from_opt_state(opt, policy_params: Mapping[str, torch.Tensor],
                         value_params: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
  """The reverse of `opt_state_from_optax`, as numpy: count, mu and nu as
  (policy tree, value tree) pairs of flax parameter trees, and the three
  counters."""
  sizes = [v.numel() for v in (*policy_params.values(),
                               *value_params.values())]

  def trees(flat):
    parts = iter(flat.detach().cpu().split(sizes))
    out = []
    for like in (policy_params, value_params):
      sd = {k: next(parts).view(v.shape) for k, v in like.items()}
      out.append(flax_from_state_dict(sd))
    return tuple(out)

  np_ = lambda t: t.detach().cpu().numpy()
  return {"count": np_(opt.count), "mu": trees(opt.mu[0]),
          "nu": trees(opt.nu[0]), "notfinite_count": np_(opt.notfinite_count),
          "last_finite": np_(opt.last_finite),
          "total_notfinite": np_(opt.total_notfinite)}


def trunk_state_dict_from_flax(params: Mapping[str, Any], device=None
                               ) -> Dict[str, torch.Tensor]:
  """A flax `ResNetTrunk` parameter tree (numpy leaves, with or without
  the top-level "params": "Conv_0" and "GroupNorm_0" of the stem, then
  "BasicBlock_<i>" with "Conv_0/1" and "GroupNorm_0/1", and "Conv_2" /
  "GroupNorm_2" where the block projects its input) as the state dict of
  `envs.visual_nets.ResNetTrunk`: kernels HWIO -> OIHW, GroupNorm scale ->
  weight."""
  if "params" in params:
    params = params["params"]
  out = {}

  def conv(key, scope):
    k = np.asarray(scope["kernel"], dtype=np.float32)
    out[key] = torch.tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)),
                            device=device)

  def norm(key, scope):
    out[key + ".weight"] = torch.tensor(
        np.asarray(scope["scale"], dtype=np.float32), device=device)
    out[key + ".bias"] = torch.tensor(
        np.asarray(scope["bias"], dtype=np.float32), device=device)

  conv("stem.weight", params["Conv_0"])
  norm("stem_norm", params["GroupNorm_0"])
  n = sum(1 for k in params if k.startswith("BasicBlock_"))
  for i in range(n):
    b = params[f"BasicBlock_{i}"]
    conv(f"blocks.{i}.conv0.weight", b["Conv_0"])
    norm(f"blocks.{i}.norm0", b["GroupNorm_0"])
    conv(f"blocks.{i}.conv1.weight", b["Conv_1"])
    norm(f"blocks.{i}.norm1", b["GroupNorm_1"])
    if "Conv_2" in b:
      conv(f"blocks.{i}.proj.0.weight", b["Conv_2"])
      norm(f"blocks.{i}.proj.1", b["GroupNorm_2"])
  return out

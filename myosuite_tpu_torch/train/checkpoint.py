"""Checkpoints of the training state, with `torch.save`.

The JAX package saves its TrainState with orbax; the port saves the same
content as one file of tensors and plain containers, `train_state.pt`, in
the same `step_<n>` directory layout. The full state is params, optimizer
state, observation stats, env state (generators as their states) and the
trainer's generator; `learner_only=True` keeps policy, value, optimizer,
obs stats and env_steps, the form for shipping a policy.

`restore` rebuilds a state in the structure of a target (a TrainState
from `PPO.init`), on the target's devices; every tensor must match the
target's shape and dtype.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

FILE = "train_state.pt"
_LEARNER = ("policy_params", "value_params", "opt_state", "obs_stats",
            "env_steps")


def _pack(x: Any) -> Any:
  """Tensors, numbers and containers only (loadable with weights_only)."""
  if dataclasses.is_dataclass(x):
    return {f.name: _pack(getattr(x, f.name)) for f in dataclasses.fields(x)}
  if isinstance(x, dict):
    return {k: _pack(v) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return [_pack(v) for v in x]
  if isinstance(x, torch.Generator):
    return x.get_state()
  if isinstance(x, torch.Tensor):
    return x.detach()
  return x


def _unpack(target: Any, saved: Any, where: str = "state") -> Any:
  """`saved` in the structure, types and devices of `target`."""
  if dataclasses.is_dataclass(target):
    return dataclasses.replace(target, **{
        f.name: _unpack(getattr(target, f.name), saved[f.name],
                        f"{where}.{f.name}")
        for f in dataclasses.fields(target)})
  if isinstance(target, dict):
    if set(target) != set(saved):
      raise ValueError(f"{where}: keys {sorted(saved)} in the checkpoint, "
                       f"{sorted(target)} in the target")
    return {k: _unpack(v, saved[k], f"{where}.{k}") for k, v in
            target.items()}
  if isinstance(target, (list, tuple)):
    if len(target) != len(saved):
      raise ValueError(f"{where}: {len(saved)} entries in the checkpoint, "
                       f"{len(target)} in the target")
    return type(target)(_unpack(t, s, f"{where}[{i}]")
                        for i, (t, s) in enumerate(zip(target, saved)))
  if isinstance(target, torch.Generator):
    g = torch.Generator(device=target.device)
    g.set_state(saved)
    return g
  if isinstance(target, torch.Tensor):
    if saved.shape != target.shape or saved.dtype != target.dtype:
      raise ValueError(f"{where}: {saved.dtype} {tuple(saved.shape)} in the "
                       f"checkpoint, {target.dtype} {tuple(target.shape)} "
                       "in the target")
    return saved.to(target.device)
  return saved


def _learner_view(ts) -> dict:
  return {k: getattr(ts, k) for k in _LEARNER}


def save(path: str, train_state, step: Optional[int] = None,
         learner_only: bool = False) -> str:
  """Write `train_state` (or its learner) under `path` (or
  `path/step_<step>`); returns the directory."""
  path = os.path.abspath(path)
  if step is not None:
    path = os.path.join(path, f"step_{step}")
  os.makedirs(path, exist_ok=True)
  payload = _pack(_learner_view(train_state) if learner_only
                  else train_state)
  tmp = os.path.join(path, FILE + ".tmp")
  torch.save(payload, tmp)
  os.replace(tmp, os.path.join(path, FILE))   # never a half-written file
  return path


def _load(path: str) -> dict:
  return torch.load(os.path.join(os.path.abspath(path), FILE),
                    map_location="cpu", weights_only=True)


def restore(path: str, target):
  """The full state saved at `path`, in the structure of `target`."""
  return _unpack(target, _load(path))


def restore_learner(path: str, train_state, skip_opt: bool = False):
  """A learner (from a full or learner-only checkpoint) into
  `train_state`; its env state and generator keep their values.

  skip_opt: keep the target's fresh optimizer state (when the restoring
  run's optimizer differs, e.g. a cosine-lr run warm-started from a
  constant-lr checkpoint)."""
  saved = _load(path)
  keys = [k for k in _LEARNER if not (skip_opt and k == "opt_state")]
  got = _unpack({k: getattr(train_state, k) for k in keys},
                {k: saved[k] for k in keys})
  return train_state.replace(**got)


def latest_step_dir(root: str) -> Optional[str]:
  if not os.path.isdir(root):
    return None
  steps = [d for d in os.listdir(root) if d.startswith("step_")]
  if not steps:
    return None
  return os.path.join(root, max(steps, key=lambda s: int(s.split("_")[1])))

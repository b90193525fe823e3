"""Env wrappers: episode bookkeeping and auto-reset on the device.

`AutoResetWrapper` is the JAX package's wrapper over a batch: at an episode
boundary (done or truncation) an env's physics, observation and task info
are replaced by a fresh reset drawn from the env's own reset distribution.
The JAX wrapper runs per env under vmap; here every step draws a
full-batch reset from the wrapper's own generator and selects it per env
with `torch.where`, so no step reads anything back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from benchmark.reference.envs.base import State

# info entries the wrapper owns (the rest are the env's, selected per env)
_OWN = ("generator", "reset_generator", "truncation", "terminal_obs",
        "episode_return", "returned_episode_return")


def _pick(boundary: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
  """new where boundary, else old, per env (leading axis)."""
  return torch.where(boundary.view((-1,) + (1,) * (old.dim() - 1)), new, old)


def _pick_info(boundary: torch.Tensor, new, old):
  """`_pick` over an info entry: a tensor, or a dict of them at any depth
  (e.g. the fatigue state), or a dataclass of them (e.g. a scripted
  opponent's state, through `_pick_fields`); anything else, or an entry
  the reset does not make, is kept."""
  if isinstance(old, torch.Tensor) and isinstance(new, torch.Tensor):
    return _pick(boundary, new, old)
  if isinstance(old, dict) and isinstance(new, dict):
    return {k: _pick_info(boundary, new.get(k), v) for k, v in old.items()}
  if (dataclasses.is_dataclass(old) and not isinstance(old, type)
      and type(new) is type(old)):
    return _pick_fields(boundary, new, old, getattr(old, "STATIC", ()))
  return old


def _pick_fields(boundary: torch.Tensor, new, old, static=()):
  """`_pick` over every field of a dataclass, descending into dataclass
  fields; fields named in `static` (tables without an env axis, the same
  on both sides) are passed through."""
  out = {}
  for f in dataclasses.fields(old):
    a, b = getattr(new, f.name), getattr(old, f.name)
    if f.name in static:
      out[f.name] = b
    elif dataclasses.is_dataclass(b):
      out[f.name] = _pick_fields(boundary, a, b, getattr(b, "STATIC", ()))
    else:
      out[f.name] = _pick(boundary, a, b)
  return type(old)(**out)


class AutoResetWrapper:
  """Wraps a batched MyoEnv with truncation and auto-reset.

  step() returns a state whose info["terminal_obs"] holds the observation
  from before any reset (for bootstrapping the value at a truncation), and
  whose data and obs are the reset's where an episode ended.
  """

  def __init__(self, env):
    self._env = env

  def __getattr__(self, name):
    return getattr(self._env, name)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    state = self._env.reset(generator, batch)
    # the wrapper's own stream, split off the caller's (one host read, at
    # reset only)
    seed = torch.randint(2 ** 62, (), generator=generator,
                         device=generator.device)
    reset_generator = torch.Generator(device=generator.device)
    reset_generator.manual_seed(int(seed))
    zero = torch.zeros(batch, device=self._env.device)
    info = {**state.info, "reset_generator": reset_generator,
            "truncation": zero, "terminal_obs": state.obs["state"],
            "episode_return": zero, "returned_episode_return": zero}
    return state.replace(info=info)

  def step(self, state: State, action: torch.Tensor) -> State:
    state = self._env.step(state, action)
    info = state.info
    truncation = info["truncation"]
    # an env whose physics diverged (NaN or inf, e.g. after an extreme
    # exploratory action) cannot recover, and its NaN would poison the
    # batch's statistics: treat it as terminal and reset it, with reward 0
    blown = ~(torch.isfinite(state.obs["state"]).all(-1)
              & torch.isfinite(state.reward))
    reward = torch.where(blown, torch.zeros_like(state.reward), state.reward)
    obs = {k: torch.nan_to_num(v) for k, v in state.obs.items()}
    done = torch.maximum(state.done, blown.to(state.done.dtype))
    boundary = (done > 0) | (truncation > 0)

    fresh = self._env.reset(info["reset_generator"], reward.shape[0])
    pick = lambda new, old: _pick(boundary, new, old)
    data = _pick_fields(boundary, fresh.data, state.data)
    new_obs = {k: pick(fresh.obs[k], v) for k, v in obs.items()}

    # env-specific info (targets etc.) comes from the reset branch too
    new_info: Dict[str, Any] = {
        k: _pick_info(boundary, fresh.info.get(k), v)
        for k, v in info.items() if k not in _OWN}
    ep_ret = info["episode_return"] + reward
    new_info.update(
        generator=info["generator"],
        reset_generator=info["reset_generator"],
        truncation=truncation,
        terminal_obs=obs["state"],
        episode_return=torch.where(boundary, torch.zeros_like(ep_ret),
                                   ep_ret),
        returned_episode_return=torch.where(
            boundary, ep_ret, info["returned_episode_return"]))
    return state.replace(data=data, obs=new_obs, reward=reward, done=done,
                         info=new_info)

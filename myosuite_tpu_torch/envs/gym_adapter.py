"""Gymnasium adapter: the classic single-env API over the batched envs.

The JAX package's `GymEnv`: one env (a batch of 1) on a device, for
single-env debugging and for code written against the classic API. It
subclasses `gymnasium.Env` and has spaces when gymnasium imports, and is a
plain class otherwise. `step` returns numpy observations, a float reward,
two bools and the metrics as numpy. `render` draws the env with the
port's ray caster (`renderer.Renderer`) as (H, W, 3) uint8 numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

try:
  import gymnasium as gym
  _BASE = gym.Env
except Exception:  # gymnasium is optional
  gym = None
  _BASE = object


class GymEnv(_BASE):
  """gymnasium.Env over a port env (a batch of one, host-driven)."""

  metadata = {"render_modes": ["rgb_array"]}

  def __init__(self, env_or_name, seed: int = 0,
               render_mode: Optional[str] = None, device=None):
    import myosuite_tpu_torch

    if isinstance(env_or_name, str):
      kw = {} if device is None else {"device": device}
      env_or_name = myosuite_tpu_torch.make(env_or_name, **kw)
    self._env = env_or_name
    self._device = self._env.device
    self._generator = torch.Generator(self._device).manual_seed(seed)
    self._state = None
    self._renderer = None
    self.render_mode = render_mode

    obs_dim = int(self._env.reset(
        torch.Generator(self._device).manual_seed(seed), 1
    ).obs["state"].shape[-1])
    if gym is not None:
      self.observation_space = gym.spaces.Box(-np.inf, np.inf, (obs_dim,),
                                              dtype=np.float32)
      self.action_space = gym.spaces.Box(-1.0, 1.0,
                                         (self._env.action_size,),
                                         dtype=np.float32)

  @property
  def unwrapped_env(self):
    return self._env

  def reset(self, *, seed: Optional[int] = None,
            options: Optional[Dict] = None) -> Tuple[np.ndarray, Dict]:
    if seed is not None:
      self._generator = torch.Generator(self._device).manual_seed(seed)
    self._state = self._env.reset(self._generator, 1)
    return self._state.obs["state"][0].cpu().numpy(), {}

  def step(self, action) -> Tuple[np.ndarray, float, bool, bool, Dict]:
    a = torch.as_tensor(np.asarray(action, dtype=np.float32),
                        device=self._device).reshape(1, -1)
    self._state = state = self._env.step(self._state, a)
    obs = state.obs["state"][0].cpu().numpy()
    reward = float(state.reward[0])
    terminated = bool(state.done[0] > 0)
    trunc = state.info.get("truncation")
    truncated = bool(trunc[0] > 0) if trunc is not None else False
    info = {k: v[0].cpu().numpy() for k, v in state.metrics.items()}
    return obs, reward, terminated, truncated, info

  def render(self) -> np.ndarray:
    if self._renderer is None:
      from myosuite_tpu_torch.renderer import Renderer
      self._renderer = Renderer(self._env)
    return self._renderer.render(self._state.data)[0].cpu().numpy()

  def close(self):
    pass

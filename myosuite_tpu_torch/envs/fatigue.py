"""3CC-r cumulative muscle fatigue over a batch of envs.

The three-compartment-controller model of the JAX package's
`envs/fatigue.py`: each muscle's motor units are split into active (MA),
resting (MR) and fatigued (MF) fractions with activation-dependent
transfer rates, a fatigue coefficient F, a recovery coefficient R and a
rest-recovery multiplier r. The state is a dict of (B, n_muscles) tensors
kept in `State.info["fatigue"]`, so the auto-reset selects it per env like
any other info entry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from myosuite_tpu_torch.envs.base import State
from myosuite_tpu_torch.physics.types import DynType, Model


@dataclasses.dataclass
class FatigueParams:
  F: torch.Tensor          # fatigue coefficient
  R: torch.Tensor          # recovery coefficient
  r: torch.Tensor          # rest recovery multiplier
  dt: torch.Tensor         # integration step (the env's ctrl_dt)
  tau_act: torch.Tensor    # (n,) activation time constants
  tau_deact: torch.Tensor  # (n,) deactivation time constants


def make_params(m: Model, dt: float) -> Tuple[FatigueParams, np.ndarray]:
  """Params on the model's device and the boolean mask of muscle
  actuators (F = 0.00912, R = 0.1 * 0.00094, r = 10 * 15)."""
  is_muscle = np.asarray(m.actuator_dyntype) == int(DynType.MUSCLE)
  idx = torch.as_tensor(np.nonzero(is_muscle)[0], device=m.device)
  dynprm = m.actuator_dynprm[idx]
  f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=m.device)
  params = FatigueParams(F=f32(0.00912), R=f32(0.1 * 0.00094),
                         r=f32(10 * 15), dt=f32(dt),
                         tau_act=dynprm[:, 0].contiguous(),
                         tau_deact=dynprm[:, 1].contiguous())
  return params, is_muscle


def init_state(params: FatigueParams, batch: int,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
  """(batch, n) fatigue state: all units rested, or with a generator
  MA = u1 and MF = u2 (1 - MA) from two uniform draws."""
  shape = (batch,) + params.tau_act.shape
  dev = params.tau_act.device
  if generator is None:
    zero = torch.zeros(shape, device=dev)
    return {"MA": zero, "MR": torch.ones(shape, device=dev),
            "MF": zero.clone()}
  ma = torch.rand(shape, generator=generator, device=dev)
  mf = torch.rand(shape, generator=generator, device=dev) * (1.0 - ma)
  return {"MA": ma, "MR": 1.0 - ma - mf, "MF": mf}


def compute_act(params: FatigueParams, target_load: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """One fatigue update of every env; target_load = desired activation in
  [0, 1], shaped like the state."""
  MA, MR, MF = state["MA"], state["MR"], state["MF"]
  TL = target_load
  F, R, r, dt = params.F, params.R, params.r, params.dt

  LD = (0.5 + 1.5 * MA) / params.tau_act
  LR = (0.5 + 1.5 * MA) / params.tau_deact

  c = torch.zeros_like(MA)
  c = torch.where((MA < TL) & (MR > (TL - MA)), LD * (TL - MA), c)
  c = torch.where((MA < TL) & (MR <= (TL - MA)), LD * MR, c)
  c = torch.where(MA >= TL, LR * (TL - MA), c)

  rR = torch.where(MA >= TL, r * R, R)

  c_min = torch.maximum(-MA / dt + F * MA, (MR - 1.0) / dt + rR * MF)
  c_max = torch.minimum((1.0 - MA) / dt + F * MA, MR / dt + rR * MF)
  c = torch.clamp(c, c_min, c_max)

  dMA = (c - F * MA) * dt
  dMR = (-c + rR * MF) * dt
  dMF = (F * MA - rR * MF) * dt
  return {"MA": MA + dMA, "MR": MR + dMR, "MF": MF + dMF}


def effort(state: Dict[str, torch.Tensor],
           target_load: torch.Tensor) -> torch.Tensor:
  """(B,) norm of MA - target_load per env."""
  return torch.linalg.vector_norm(state["MA"] - target_load, dim=-1)


class FatigueWrapper:
  """Env wrapper: muscle controls are replaced by the fatigued activation
  MA, with the fatigue state in info["fatigue"] (and, if asked, MA, MR and
  MF appended to obs["state"])."""

  def __init__(self, env, fatigue_reset_random: bool = False,
               fatigue_in_obs: bool = False):
    self._env = env
    self._random_reset = fatigue_reset_random
    self._in_obs = fatigue_in_obs
    self.params, self._muscle_mask = make_params(env.model, env.dt)
    self._muscle_idx = torch.as_tensor(np.nonzero(self._muscle_mask)[0],
                                       device=env.device)

  def __getattr__(self, name):
    return getattr(self._env, name)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    state = self._env.reset(generator, batch)
    fat = init_state(self.params, batch,
                     generator if self._random_reset else None)
    state = state.replace(info={**state.info, "fatigue": fat})
    if self._in_obs:
      state = state.replace(obs=self._augment_obs(state.obs, fat))
    return state

  def _augment_obs(self, obs, fat):
    return {**obs, "state": torch.cat(
        [obs["state"], fat["MA"], fat["MR"], fat["MF"]], dim=-1)}

  def step(self, state: State, action: torch.Tensor) -> State:
    ctrl = action
    if self._env.config.get("norm_actions", True):
      ctrl = self._env.norm_actions(action)
    fat = compute_act(self.params, ctrl[:, self._muscle_idx],
                      state.info["fatigue"])
    ctrl = ctrl.index_copy(1, self._muscle_idx, fat["MA"])
    # before and after: the env's _get_info may rebuild info
    state = state.replace(info={**state.info, "fatigue": fat})
    state = self._env.step_ctrl(state, ctrl)
    state = state.replace(info={**state.info, "fatigue": fat})
    if self._in_obs:
      state = state.replace(obs=self._augment_obs(state.obs, fat))
    return state

"""The OSL prosthetic leg's state-machine controller, batched.

A 4-phase gait machine (early stance, late stance, early swing, late
swing) with per-phase impedance (PD) control of the prosthetic knee and
ankle: the JAX package's controller, whose tables are copied here. Each
env carries its phase (int32); the gains of every parameter set and phase
live in one (n_sets, 4, 6) table and the transition thresholds in an
(n_sets, 7) table, so the set and phase of each env are gathers and the
transitions are masked updates.

Sign conventions of the leg model: knee flexion is negative, ankle
dorsiflexion positive.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# phase ids
E_STANCE, L_STANCE, E_SWING, L_SWING = 0, 1, 2, 3
PHASE_NAMES = ("e_stance", "l_stance", "e_swing", "l_swing")
N_SETS = 4

_D = np.deg2rad

# Per-phase gains, columns: knee_target, knee_stiffness, knee_damping,
# ankle_target, ankle_stiffness, ankle_damping
_DEFAULT_GAINS = np.array([
    [-_D(5.0), 99.372, 3.180, _D(-2.0), 19.874, 0.000],      # e_stance
    [-_D(8.0), 99.372, 1.272, _D(-20.0), 79.498, 0.063],     # l_stance
    [-_D(60.0), 39.749, 0.063, _D(25.0), 7.949, 0.000],      # e_swing
    [-_D(5.0), 15.899, 3.816, _D(15.0), 7.949, 0.000],       # l_swing
], dtype=np.float32)

# Transition thresholds (a transition fires when any of its own is met):
#   0 load_estance   e_stance -> l_stance when load > 0.25 BW
#   1 ankle_estance  e_stance -> l_stance when ankle > 6 deg dorsiflexion
#   2 load_lstance   l_stance -> e_swing when load < 0.15 BW
#   3 knee_eswing    e_swing -> l_swing when knee flexed beyond 50 deg
#   4 kneevel_eswing e_swing -> l_swing when knee velocity < 3 deg/s
#   5 load_lswing    l_swing -> e_stance when load > 0.40 BW
#   6 knee_lswing    l_swing -> e_stance when knee flexed under 30 deg
# The loads are fractions of body weight unless make_osl_params scales
# them by a body mass.
_DEFAULT_THRESH = np.array(
    [0.25, _D(6.0), 0.15, _D(50.0), _D(3.0), 0.40, _D(30.0)],
    dtype=np.float32)

# peak torques of the hardware (N m)
KNEE_PEAK_TORQUE = 142.272
ANKLE_PEAK_TORQUE = 168.192


class OslParams(NamedTuple):
  """n_sets independent parameter sets."""
  gains: torch.Tensor    # (n_sets, 4, 6)
  thresh: torch.Tensor   # (n_sets, 7)


def make_osl_params(body_mass: Optional[float] = None, n_sets: int = N_SETS,
                    device=None) -> OslParams:
  """The default parameter sets. With `body_mass` (kg) the load
  thresholds (indices 0, 2, 5) become Newtons at body_mass * 9.81, and
  osl_step must be fed the raw vertical load; without it they stay
  fractions of body weight."""
  thresh1 = _DEFAULT_THRESH.copy()
  if body_mass is not None:
    thresh1[[0, 2, 5]] *= float(body_mass) * 9.81
  gains = np.broadcast_to(_DEFAULT_GAINS, (n_sets,) + _DEFAULT_GAINS.shape)
  thresh = np.broadcast_to(thresh1, (n_sets,) + thresh1.shape)
  return OslParams(torch.tensor(gains.copy(), device=device),
                   torch.tensor(thresh.copy(), device=device))


def set_osl_param_batch(params: OslParams, mode: int, gains=None,
                        thresh=None) -> OslParams:
  """`params` with mode `mode`'s gain and / or threshold table replaced."""
  g, t = params.gains.clone(), params.thresh.clone()
  if gains is not None:
    g[mode] = torch.as_tensor(gains, dtype=g.dtype, device=g.device)
  if thresh is not None:
    t[mode] = torch.as_tensor(thresh, dtype=t.dtype, device=t.device)
  return OslParams(g, t)


def set_osl_param(params: OslParams, mode: int, phase: int, column: int,
                  value: float) -> OslParams:
  """`params` with one gain entry replaced."""
  g = params.gains.clone()
  g[mode, phase, column] = value
  return OslParams(g, params.thresh)


def osl_step(phase: torch.Tensor, params: OslParams, knee_q: torch.Tensor,
             knee_v: torch.Tensor, ankle_q: torch.Tensor,
             ankle_v: torch.Tensor, load: torch.Tensor,
             mode: Optional[torch.Tensor] = None):
  """One controller tick of every env.

  phase (B,) int32; knee / ankle angle and velocity and the load (B,)
  each; mode (B,) int parameter set per env, default set 0. Returns (new
  phase, knee torque, ankle torque).
  """
  B = phase.shape[0]
  midx = 0 if mode is None else mode.long()
  gains = params.gains[midx].expand(B, -1, -1)     # (B, 4, 6)
  th = params.thresh[midx].expand(B, -1)           # (B, 7)

  to_lstance = (phase == E_STANCE) & ((load > th[:, 0])
                                      | (ankle_q > th[:, 1]))
  to_eswing = (phase == L_STANCE) & (load < th[:, 2])
  # model knee velocity = -(the OSL's knee velocity)
  to_lswing = (phase == E_SWING) & ((knee_q < -th[:, 3])
                                    | (-knee_v < th[:, 4]))
  to_estance = (phase == L_SWING) & ((load > th[:, 5])
                                     | (knee_q > -th[:, 6]))
  new_phase = phase
  new_phase = torch.where(to_lstance, L_STANCE, new_phase)
  new_phase = torch.where(to_eswing, E_SWING, new_phase)
  new_phase = torch.where(to_lswing, L_SWING, new_phase)
  new_phase = torch.where(to_estance, E_STANCE, new_phase)

  row = gains[torch.arange(B, device=phase.device), new_phase.long()]
  knee_tau = torch.clamp(row[:, 1] * (row[:, 0] - knee_q)
                         - row[:, 2] * knee_v,
                         -KNEE_PEAK_TORQUE, KNEE_PEAK_TORQUE)
  ankle_tau = torch.clamp(row[:, 4] * (row[:, 3] - ankle_q)
                          - row[:, 5] * ankle_v,
                          -ANKLE_PEAK_TORQUE, ANKLE_PEAK_TORQUE)
  return new_phase.to(torch.int32), knee_tau, ankle_tau

"""Spinal reflex locomotion controller (Song & Geyer 2015), batched.

The JAX package's reflex baseline: a feedback controller that turns
proprioception (muscle force and length), ground reaction forces and the
trunk's orientation into muscle stimulations, with no learning. The JAX
controller is written for one env under `vmap`; this one takes a batch of
`Data` with a leading env axis and keeps the JAX package's order of
operations (the tuned gains span 1e-36 to 4e37, so a reordered product can
overflow where the JAX one does not).

Pathways (per leg, gated by stance / swing from the GRF):
  M1  stance: positive force feedback on anti-gravity muscles
      (SOL/GAS/VAS/GMAX).
  M2  stance: trunk balance PD on hip muscles (lean angle + rate).
  M3  always: TA length feedback minus SOL force inhibition.
  M4  swing:  hip flexor drive, and early-swing knee flexion (BFSH).
  M5  late swing: hamstring force feedback and leg retraction.
plus a gait-initiation kick in the first ~0.4 s and abductor / adductor
feedback against pelvis roll.

The JAX controller reads actuator, geom and joint names with MuJoCo; the
port reads the same tables from the leg's model file (the "reflex" entry
of the env's config, from its cfg_reflex_* arrays): per side and group the
actuator masks, the feet's contact-slot masks, the hip-flexion qpos
addresses and the body weight.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from myosuite_tpu_torch.physics.types import Data

SIDES = ("r", "l")
# muscle groups per side (actuator "<side>_<NAME>")
GROUPS = {
    "sol": ("SOL", "TP", "FDL", "FHL", "PERLONG", "PERBREV", "FDB"),
    "gas": ("GASMED", "GASLAT"),
    "vas": ("VASLAT", "VASMED", "VASINT"),
    "gmax": ("GMAX1", "GMAX2", "GMAX3"),
    "ta": ("TA", "EDL", "EHL"),
    "hfl": ("PSOAS", "ILIACUS", "RF", "SAR", "TFL"),
    "ham": ("SEMIMEM", "SEMITEN", "BFLH", "BFSH"),
    "bfsh": ("BFSH",),
    "hab": ("GMED1", "GMED2", "GMED3", "GMIN"),
    "had": ("ADDLONG", "ADDBREV", "ADDMAG1", "ADDMAG2", "ADDMAG3", "GRA"),
}
# the feet's geoms per side, whose contacts make the side's GRF
FOOT_GEOMS = ("heel_geom", "foot_geom", "toes_geom")


@dataclasses.dataclass
class ReflexParams:
  """Reflex gains (the baseline's tunable parameter vector), float32."""
  g_sol: float      # F+ gain, plantarflexors
  g_gas: float
  g_vas: float      # F+ gain, knee extensors
  g_gmax: float     # F+ gain, hip extensors
  g_ta: float       # TA length feedback gain
  l_off_ta: float   # TA length feedback offset (normalized length)
  g_solta: float    # SOL -> TA inhibition
  g_hip_p: float    # trunk balance P gain
  g_hip_d: float    # trunk balance D gain
  theta_ref: float  # desired trunk pitch (rad, forward lean)
  g_hfl: float      # swing hip flexor drive
  g_ham: float      # late-swing hamstring F+ gain
  s0: float         # baseline stimulation
  g_bfsh: float     # early-swing knee flexion (ground clearance)
  g_retract: float  # late-swing leg retraction vs hip angle
  g_kick: float     # gait-initiation impulse (left leg, ~first 0.4 s)
  k_swing: float    # load-difference swing-gate sharpness

  def __post_init__(self):
    # the JAX package's gains are float32 scalars
    for f in dataclasses.fields(self):
      setattr(self, f.name, float(np.float32(getattr(self, f.name))))


def default_params() -> ReflexParams:
  """Hand-tuned defaults in the range of Song & Geyer Table 1."""
  return ReflexParams(
      g_sol=1.2 / 4000, g_gas=1.1 / 1500, g_vas=1.2 / 6000,
      g_gmax=1.0 / 1500, g_ta=1.1, l_off_ta=0.71, g_solta=0.0003,
      g_hip_p=1.9, g_hip_d=0.25, theta_ref=0.105, g_hfl=0.45,
      g_ham=1.0 / 3000, s0=0.01,
      # new-pathway gains start small
      g_bfsh=0.1, g_retract=0.1, g_kick=0.1, k_swing=8.0)


def params_from_json(path: str) -> ReflexParams:
  """The "params" of a tuned gains file (the shipped reflex_gait.json)."""
  with open(path) as f:
    return ReflexParams(**json.load(f)["params"])


class ReflexController:
  """The reflex network bound to a leg env (its actuator groups, foot
  contact slots, hip addresses and weight, from its model file)."""

  def __init__(self, env, params: Optional[ReflexParams] = None):
    tables = env.config.get("reflex")
    if tables is None:
      raise ValueError("the env's model file has no reflex tables "
                       "(cfg_reflex_*): only the myoLeg walk models do")
    self._env = env
    self.params = params or default_params()
    dev = env.device
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=dev)
    names = [str(n) for n in tables["group_names"]]
    self._masks = {s: {g: f32(tables["masks"][i, names.index(g)])
                       for g in GROUPS} for i, s in enumerate(SIDES)}
    self._grf = {s: f32(tables["grf"][i]) for i, s in enumerate(SIDES)}
    self._hip_qadr = {s: int(tables["hip_qadr"][i])
                      for i, s in enumerate(SIDES)}
    self._weight = float(tables["weight"])
    self._length0 = torch.clamp(env.model.actuator_length0, min=1e-6)

  @staticmethod
  def _trunk_pitch(qpos: torch.Tensor) -> torch.Tensor:
    q = qpos[:, 3:7]   # free-root quaternion; pitch about +y
    return torch.atan2(2 * (q[:, 0] * q[:, 2] - q[:, 1] * q[:, 3]),
                       1 - 2 * (q[:, 1] ** 2 + q[:, 2] ** 2))

  def __call__(self, data: Data, params: Optional[ReflexParams] = None
               ) -> torch.Tensor:
    """Muscle stimulations (B, nu) in [0, 1] from a batch of Data."""
    p = params or self.params
    col = lambda x: x[:, None]           # (B,) against (B, nu)
    theta = self._trunk_pitch(data.qpos)
    dtheta = data.qvel[:, 4]
    force = torch.abs(data.actuator_force)
    lnorm = data.actuator_length / self._length0
    batch, nu = force.shape

    stim = torch.full((batch, nu), p.s0, dtype=torch.float32,
                      device=force.device)
    loads = {s: (data.contact_force @ self._grf[s]) / self._weight
             for s in SIDES}
    # gait initiation: a Gaussian bump at 0.25 s that lifts the left leg
    # and pushes off the right
    kick = torch.exp(-((data.time - 0.25) / 0.12) ** 2)
    nq = data.qpos.shape[1]
    roll = data.qpos[:, 4] if nq > 4 else torch.zeros_like(theta)
    for side in SIDES:
      mk = self._masks[side]
      other = "l" if side == "r" else "r"
      load = loads[side]
      stance = torch.clamp(load * 5.0, 0.0, 1.0)   # smooth stance gate
      contra = torch.clamp(loads[other] * 5.0, 0.0, 1.0)
      swing = 1.0 - stance
      asym = torch.sigmoid(p.k_swing * (loads[other] - load) - 1.0)
      adr = self._hip_qadr[side]
      hipq = data.qpos[:, adr] if adr >= 0 else torch.zeros_like(theta)
      if side == "l":
        stim = stim + col(p.g_kick * kick) * (mk["hfl"] + 0.7 * mk["bfsh"])
      else:
        stim = stim + col(p.g_kick * kick * 0.6) * (mk["sol"] + mk["gas"])

      def fplus(gain, mask):
        """Positive force feedback of the group's own force, (B, 1)."""
        return col(gain * torch.sum(mask * force, -1)
                   / torch.clamp(torch.sum(mask), min=1.0))

      # M1: anti-gravity force feedback in stance
      stim = stim + col(stance) * (
          mk["sol"] * fplus(p.g_sol, mk["sol"])
          + mk["gas"] * fplus(p.g_gas, mk["gas"])
          + mk["vas"] * fplus(p.g_vas, mk["vas"])
          + mk["gmax"] * fplus(p.g_gmax, mk["gmax"]))
      # M2: trunk balance PD on hip muscles
      lean = (theta - p.theta_ref) + p.g_hip_d / max(
          p.g_hip_p, float(np.float32(1e-6))) * dtheta
      stim = stim + col(stance * p.g_hip_p) * (
          mk["gmax"] * col(torch.clamp(lean, min=0.0))
          + mk["hfl"] * col(torch.clamp(-lean, min=0.0)))
      # M3: TA length feedback minus SOL force inhibition (always on)
      ta_l = torch.sum(mk["ta"] * lnorm, -1) / torch.clamp(
          torch.sum(mk["ta"]), min=1.0)
      sol_f = torch.sum(mk["sol"] * force, -1) / torch.clamp(
          torch.sum(mk["sol"]), min=1.0)
      stim = stim + mk["ta"] * col(torch.clamp(
          p.g_ta * (ta_l - p.l_off_ta) - stance * p.g_solta * sol_f,
          min=0.0))
      # M4: swing hip flexor drive
      stim = stim + col(swing) * mk["hfl"] * p.g_hfl
      # M4b: early-swing knee flexion for ground clearance, gated by the
      # load asymmetry and contralateral support
      stim = stim + col(asym * contra) * mk["bfsh"] * col(
          p.g_bfsh * torch.clamp(0.4 - hipq, min=0.0))
      # M5: late-swing hamstring force feedback and leg retraction
      stim = stim + col(swing) * mk["ham"] * fplus(p.g_ham, mk["ham"])
      retract = p.g_retract * torch.clamp(hipq - 0.45, min=0.0)
      stim = stim + col(asym * retract) * (mk["ham"] + 0.5 * mk["gmax"])
      # lateral stability: abductors against pelvis roll
      sign = 1.0 if side == "r" else -1.0
      stim = stim + col(stance * 0.3) * (
          mk["hab"] * col(torch.clamp(sign * roll, min=0.0))
          + mk["had"] * col(torch.clamp(-sign * roll, min=0.0)))

    return torch.clamp(stim, 0.0, 1.0)

  def rollout(self, generator: torch.Generator, horizon: int,
              batch: int = 1) -> Tuple[object, Dict[str, torch.Tensor]]:
    """A closed-loop rollout of `batch` envs through `step_ctrl`
    (stimulations bypass the policy's sigmoid); (last state, a dict of the
    per-step reward, solved, root x and pelvis height, each (horizon,
    batch), the stimulations, (horizon, batch, nu), and the reset's root
    x0, (batch,))."""
    env = self._env
    state = env.reset(generator, batch)
    out = {"reward": [], "solved": [], "x": [], "height": [], "stim": []}
    x0 = state.data.qpos[:, 0]
    for _ in range(horizon):
      stim = self(state.data)
      out["stim"].append(stim)
      state = env.step_ctrl(state, stim)
      out["reward"].append(state.reward)
      out["solved"].append(state.metrics.get("solved",
                                             torch.zeros_like(state.reward)))
      out["x"].append(state.data.qpos[:, 0])
      out["height"].append(env._pelvis_height(state.data))
    return state, {"x0": x0, **{k: torch.stack(v) for k, v in out.items()}}

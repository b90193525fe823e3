"""Constraint assembly: dof friction loss, joint limits and tendon limits.

Builds a dense batched constraint system (J, aref, R, floss, active)
following MuJoCo's soft-constraint model (solref/solimp impedances), which
the Newton solve consumes. Row layout: [dof friction] [joint limits]
[tendon limits]; friction rows are a prefix, so the solver needs only
their count. Activity is a mask, not a shape.

Contact rows are not ported yet (ROADMAP.md, queue A: "Contacts");
`make_efc` raises for a model that has contact slots.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from myosuite_tpu_torch.physics.types import (Data, JointType, Model,
                                              index_tensor)

_MINVAL = 1e-15


class Efc(NamedTuple):
  """Dense batched constraint system."""
  J: torch.Tensor           # (B, nefc, nv)
  aref: torch.Tensor        # (B, nefc)
  R: torch.Tensor           # (B, nefc)
  floss: torch.Tensor       # (B, nefc) frictionloss bound (friction rows)
  active: torch.Tensor      # (B, nefc) bool: row participates
  n_friction: int           # rows [0, n_friction) are friction rows


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """Impedance d(x); solimp (..., 5), pos (...)."""
  dmin, dmax, width = solimp[..., 0], solimp[..., 1], solimp[..., 2]
  mid = torch.clamp(solimp[..., 3], 1e-4, 1.0 - 1e-4)
  power = torch.clamp(solimp[..., 4], min=1.0)
  x = torch.clamp(pos.abs() / torch.clamp(width, min=_MINVAL), 0.0, 1.0)
  y_low = torch.pow(x / mid, power) * mid
  y_high = 1.0 - torch.pow((1.0 - x) / (1.0 - mid), power) * (1.0 - mid)
  y = torch.where(x < mid, y_low, y_high)
  return torch.clamp(dmin + y * (dmax - dmin), 1e-5, 1.0 - 1e-5)


def _kbi(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
  """Stiffness, damping and impedance; solref (..., 2)."""
  imp = _impedance(solimp, pos)
  dmax = torch.clamp(solimp[..., 1], min=1e-5)
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  standard = timeconst > 0
  k_std = 1.0 / torch.clamp(dmax * dmax * timeconst * timeconst *
                            dampratio * dampratio, min=_MINVAL)
  b_std = 2.0 / torch.clamp(dmax * timeconst, min=_MINVAL)
  k = torch.where(standard, k_std,
                  -solref[..., 0] / torch.clamp(dmax * dmax, min=_MINVAL))
  b = torch.where(standard, b_std,
                  -solref[..., 1] / torch.clamp(dmax, min=_MINVAL))
  return k, b, imp


class Plan(NamedTuple):
  fr_dof: torch.Tensor      # dofs with frictionloss
  fr_jnt: torch.Tensor      # owning joint per friction row
  fr_J: torch.Tensor        # (n_fr, nv) one-hot rows
  lim_jnt: torch.Tensor     # limited slide/hinge joints
  lim_qadr: torch.Tensor
  lim_vadr: torch.Tensor
  lim_J: torch.Tensor       # (n_jlim, nv) one-hot rows
  lim_ten: torch.Tensor     # limited tendons
  nefc: int
  n_fr: int
  n_jlim: int
  n_tlim: int


def make_plan(m: Model) -> Plan:
  dev = m.device
  idx = lambda x: index_tensor(x, dev)
  floss = m.dof_frictionloss.detach().cpu().numpy()
  fr_dof = np.nonzero(floss > 0)[0]
  is_lim = m.jnt_limited.astype(bool) & np.isin(
      m.jnt_type, [JointType.SLIDE, JointType.HINGE])
  lim_jnt = np.nonzero(is_lim)[0]
  lim_vadr = m.jnt_dofadr[lim_jnt]
  lim_ten = np.nonzero(m.tendon_limited)[0]

  def one_hot(cols):
    eye = np.zeros((len(cols), m.nv), dtype=np.float32)
    eye[np.arange(len(cols)), cols] = 1.0
    return torch.as_tensor(eye, device=dev)

  n_fr, n_jlim, n_tlim = len(fr_dof), len(lim_jnt), len(lim_ten)
  return Plan(fr_dof=idx(fr_dof), fr_jnt=idx(m.dof_jntid[fr_dof]),
              fr_J=one_hot(fr_dof), lim_jnt=idx(lim_jnt),
              lim_qadr=idx(m.jnt_qposadr[lim_jnt]), lim_vadr=idx(lim_vadr),
              lim_J=one_hot(lim_vadr), lim_ten=idx(lim_ten),
              nefc=n_fr + n_jlim + n_tlim, n_fr=n_fr, n_jlim=n_jlim,
              n_tlim=n_tlim)


def _r(imp, invweight):
  return torch.clamp((1.0 - imp) / torch.clamp(imp, min=_MINVAL) * invweight,
                     min=_MINVAL)


def _limit_rows(dist_lo, dist_hi, margin, solref, solimp):
  sign = torch.where(dist_lo < dist_hi, 1.0, -1.0)
  dist = torch.minimum(dist_lo, dist_hi)
  pos = dist - margin
  k, b, imp = _kbi(solref, solimp, pos)
  return sign, pos, k, b, imp, dist < margin


def make_efc(m: Model, d: Data) -> Efc:
  """Assemble the batched constraint system for the current state."""
  if m.ncon_max:
    raise NotImplementedError(
        "contact constraints are not ported yet (ROADMAP.md, queue A: "
        "Contacts)")
  plan: Plan = m.plan["constraint"]
  B, nv = d.batch, m.nv
  qvel = d.qvel
  if plan.nefc == 0:
    z = qvel.new_zeros(B, 0)
    return Efc(J=qvel.new_zeros(B, 0, nv), aref=z, R=torch.ones_like(z),
               floss=z, active=z.bool(), n_friction=0)

  Js, arefs, Rs, flosses, actives = [], [], [], [], []

  if plan.n_fr:
    k, b, imp = _kbi(m.jnt_solref[plan.fr_jnt], m.jnt_solimp[plan.fr_jnt],
                     qvel.new_zeros(plan.n_fr))
    Js.append(plan.fr_J.expand(B, -1, -1))
    arefs.append(-b * qvel[:, plan.fr_dof])
    Rs.append(_r(imp, m.dof_invweight0[plan.fr_dof]).expand(B, -1))
    flosses.append(m.dof_frictionloss[plan.fr_dof].expand(B, -1))
    actives.append(torch.ones(B, plan.n_fr, dtype=torch.bool,
                              device=qvel.device))

  if plan.n_jlim:
    j = plan.lim_jnt
    q = d.qpos[:, plan.lim_qadr]
    sign, pos, k, b, imp, active = _limit_rows(
        q - m.jnt_range[j, 0], m.jnt_range[j, 1] - q, m.jnt_margin[j],
        m.jnt_solref[j], m.jnt_solimp[j])
    Js.append(plan.lim_J * sign[..., None])
    arefs.append(-b * (sign * qvel[:, plan.lim_vadr]) - k * imp * pos)
    Rs.append(_r(imp, m.dof_invweight0[plan.lim_vadr]))
    flosses.append(qvel.new_zeros(B, plan.n_jlim))
    actives.append(active)

  if plan.n_tlim:
    t = plan.lim_ten
    length = d.ten_length[:, t]
    sign, pos, k, b, imp, active = _limit_rows(
        length - m.tendon_range[t, 0], m.tendon_range[t, 1] - length,
        m.tendon_margin[t], m.tendon_solref_lim[t], m.tendon_solimp_lim[t])
    J = sign[..., None] * d.ten_J[:, t]
    Js.append(J)
    arefs.append(-b * torch.matmul(J, qvel[..., None])[..., 0]
                 - k * imp * pos)
    Rs.append(_r(imp, m.tendon_invweight0[t]))
    flosses.append(qvel.new_zeros(B, plan.n_tlim))
    actives.append(active)

  return Efc(J=torch.cat(Js, 1), aref=torch.cat(arefs, 1),
             R=torch.cat(Rs, 1), floss=torch.cat(flosses, 1),
             active=torch.cat(actives, 1), n_friction=plan.n_fr)

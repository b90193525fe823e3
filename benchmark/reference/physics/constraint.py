"""Constraint assembly: dof friction loss, joint and tendon limits,
contacts.

Builds a dense batched constraint system (J, aref, R, floss, active)
following MuJoCo's soft-constraint model (solref/solimp impedances), which
the Newton solve consumes. Row layout: [dof friction] [joint limits]
[tendon limits] [contact rows]; friction rows are a prefix, so the solver
needs only their count. Activity is a mask, not a shape.

Contacts use the pyramidal cone, grouped by condim: a condim-1 contact is
one normal row; a condim-c contact has 2 (c - 1) edge rows J0 +- mu_i J_i,
emitted axis by axis, + before -, each over the group's contacts (the JAX
package's row order). `Plan.con_slots` maps each row to its contact slot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.physics import math
from benchmark.reference.physics.collision import slot_pairs
from benchmark.reference.physics.types import (Data, JointType, Model,
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
  con_groups: tuple         # ((condim, slot ids), ...) by ascending condim
  con_slots: torch.Tensor   # (nefc,) contact slot per row, -1 elsewhere
  con_rows: torch.Tensor    # rows of contacts (con_slots >= 0)
  con_force: math.FixedRows  # (slots, nefc): a slot's rows, summed
  con_body1: torch.Tensor   # (ncon,) body of each slot's geoms
  con_body2: torch.Tensor
  nefc: int
  n_fr: int
  n_jlim: int
  n_tlim: int
  n_con: int                # contact rows


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

  slots = slot_pairs(m)
  slot_dims = slots[:, 3]
  con_groups = tuple((int(c), np.nonzero(slot_dims == c)[0])
                     for c in sorted(set(slot_dims.tolist())))
  n_fr, n_jlim, n_tlim = len(fr_dof), len(lim_jnt), len(lim_ten)
  # row -> contact slot, in make_efc's row order
  con_slots = np.concatenate(
      [-np.ones(n_fr + n_jlim + n_tlim, dtype=np.int64)]
      + [np.tile(ids, 1 if c == 1 else 2 * (c - 1)) for c, ids in con_groups])
  con_rows = np.nonzero(con_slots >= 0)[0]
  return Plan(fr_dof=idx(fr_dof), fr_jnt=idx(m.dof_jntid[fr_dof]),
              fr_J=one_hot(fr_dof), lim_jnt=idx(lim_jnt),
              lim_qadr=idx(m.jnt_qposadr[lim_jnt]), lim_vadr=idx(lim_vadr),
              lim_J=one_hot(lim_vadr), lim_ten=idx(lim_ten),
              con_groups=tuple((c, idx(ids)) for c, ids in con_groups),
              con_slots=idx(con_slots), con_rows=idx(con_rows),
              con_force=math.fixed_rows(
                  con_slots[None, :] == np.arange(len(slots))[:, None], dev),
              con_body1=idx(m.geom_bodyid[slots[:, 0]]),
              con_body2=idx(m.geom_bodyid[slots[:, 1]]),
              nefc=len(con_slots), n_fr=n_fr, n_jlim=n_jlim, n_tlim=n_tlim,
              n_con=len(con_rows))


def _r(imp, invweight):
  return torch.clamp((1.0 - imp) / torch.clamp(imp, min=_MINVAL) * invweight,
                     min=_MINVAL)


def _limit_rows(dist_lo, dist_hi, margin, solref, solimp):
  sign = torch.where(dist_lo < dist_hi, 1.0, -1.0)
  dist = torch.minimum(dist_lo, dist_hi)
  pos = dist - margin
  k, b, imp = _kbi(solref, solimp, pos)
  return sign, pos, k, b, imp, dist < margin


def _contact_rows(m: Model, d: Data, plan: Plan):
  """(J, aref, R, floss, active) of each condim group's pyramidal rows."""
  kin = m.plan["kinematics"]
  con = d.contact
  B, qvel = d.batch, d.qvel
  b1, b2 = plan.con_body1, plan.con_body2
  com_root = d.subtree_com[:, kin.root]                  # (B, nbody, 3)

  def pts_jac(bodies):
    """Translational Jacobians (B, ncon, nv, 3) of the contact points as
    points of `bodies`."""
    offset = con.pos - com_root[:, bodies]               # (B, ncon, 3)
    jacp = (math.cross(d.cdof[:, None, :, :3], offset[:, :, None, :])
            + d.cdof[:, None, :, 3:])
    return jacp * kin.body_dof_mask[bodies][None, :, :, None]

  jdiff = pts_jac(b2) - pts_jac(b1)
  jc = math.fixed_mm(con.frame, jdiff.transpose(-1, -2))  # (B, ncon, 3, nv)
  pos_err = con.dist - con.includemargin
  active = con.dist < con.includemargin
  k, b, imp = _kbi(con.solref, con.solimp, pos_err)
  invweight = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]

  for condim, ids in plan.con_groups:
    kimp = k[:, ids] * imp[:, ids] * pos_err[:, ids]
    if condim == 1:
      J = jc[:, ids, 0]
      yield (J, -b[:, ids] * _mv(J, qvel) - kimp,
             _r(imp[:, ids], invweight[ids]),
             qvel.new_zeros(B, len(ids)), active[:, ids])
      continue
    mu = con.friction[:, ids, 0]
    iw = (invweight[ids] * 2.0 * mu * mu) / m.opt.impratio
    nrep = 2 * (condim - 1)
    J = torch.cat([jc[:, ids, 0] + sgn * con.friction[:, ids, ax - 1, None]
                   * jc[:, ids, ax]
                   for ax in range(1, condim) for sgn in (1.0, -1.0)], 1)
    rep = lambda x: x.repeat(1, nrep)
    yield (J, -rep(b[:, ids]) * _mv(J, qvel) - rep(kimp),
           rep(_r(imp[:, ids], iw)), qvel.new_zeros(B, nrep * len(ids)),
           rep(active[:, ids]))


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  return math.fixed_mv(A, x)


def make_efc(m: Model, d: Data) -> Efc:
  """Assemble the batched constraint system for the current state."""
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
    arefs.append(-b * _mv(J, qvel) - k * imp * pos)
    Rs.append(_r(imp, m.tendon_invweight0[t]))
    flosses.append(qvel.new_zeros(B, plan.n_tlim))
    actives.append(active)

  if plan.n_con:
    for rows in _contact_rows(m, d, plan):
      for out, x in zip((Js, arefs, Rs, flosses, actives), rows):
        out.append(x)

  return Efc(J=torch.cat(Js, 1), aref=torch.cat(arefs, 1),
             R=torch.cat(Rs, 1), floss=torch.cat(flosses, 1),
             active=torch.cat(actives, 1), n_friction=plan.n_fr)

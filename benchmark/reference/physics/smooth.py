"""Smooth dynamics: dense mass matrix, bias forces, passive forces
(mj_crb, mj_rne, mj_passive), batched over envs.

qM is dense (B, nv, nv): myo models have nv <= ~60. Subtree sums (CRB
inertia, RNE forces) and body accelerations are products with the
model's static masks instead of tree walks. qM is factored inside the
Newton kernel (the fused solve), so there is no factor_m stage.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.physics import math
from benchmark.reference.physics.types import (Data, JointType, Model,
                                              index_tensor)


class Plan(NamedTuple):
  ancestor_mask: torch.Tensor   # (nv, nv) lower: dof j is i or its ancestor
  dof_body: torch.Tensor
  # joint springs, only joints with stiffness (host-pruned like the JAX
  # package): (joint ids, qpos addresses, dof addresses) per joint class
  spring_lin: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
  spring_ball: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
  spring_free: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def make_plan(m: Model) -> Plan:
  mask = np.zeros((m.nv, m.nv), dtype=np.float32)
  for i in range(m.nv):
    j = i
    while j >= 0:
      mask[i, j] = 1.0
      j = int(m.dof_parentid[j])
  stiff = m.jnt_stiffness.detach().cpu().numpy()
  dev = m.device

  def springs(types):
    j = np.nonzero((stiff != 0.0) & np.isin(m.jnt_type, types))[0]
    return (index_tensor(j, dev), index_tensor(m.jnt_qposadr[j], dev),
            index_tensor(m.jnt_dofadr[j], dev))

  return Plan(ancestor_mask=torch.as_tensor(mask, device=dev),
              dof_body=index_tensor(m.dof_bodyid, dev),
              spring_lin=springs([JointType.SLIDE, JointType.HINGE]),
              spring_ball=springs([JointType.BALL]),
              spring_free=springs([JointType.FREE]))


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body dense mass matrix."""
  plan: Plan = m.plan["smooth"]
  kin = m.plan["kinematics"]
  crb_inert = math.rows_apply(kin.subtree, d.cinert, 1)      # (B, nbody, 10)
  f = math.inert_vec(crb_inert[:, plan.dof_body], d.cdof)    # (B, nv, 6)
  m1 = math.fixed_mm(f, d.cdof.transpose(-1, -2))            # (B, nv, nv)
  lower = m1 * plan.ancestor_mask
  qm = (lower + lower.transpose(-1, -2)
        - torch.diag_embed(torch.diagonal(lower, dim1=-2, dim2=-1)))
  return d.replace(qM=qm + torch.diag(m.dof_armature))


def rne(m: Model, d: Data) -> Data:
  """Bias forces C(q, v) by recursive Newton-Euler at zero acceleration."""
  plan: Plan = m.plan["smooth"]
  kin = m.plan["kinematics"]
  grav = m.opt.gravity
  cacc0 = torch.cat([torch.zeros_like(grav), -grav])
  cacc = cacc0 + math.rows_apply(kin.body_dofs,
                                 d.cdof_dot * d.qvel[..., None], 1)
  cfrc = (math.inert_vec(d.cinert, cacc)
          + math.motion_cross_force(d.cvel, math.inert_vec(d.cinert, d.cvel)))
  cfrc_total = math.rows_apply(kin.subtree, cfrc, 1)
  qfrc_bias = (d.cdof * cfrc_total[:, plan.dof_body]).sum(-1)
  return d.replace(qfrc_bias=qfrc_bias)


def passive(m: Model, d: Data) -> Data:
  """Joint damping and springs, tendon springs (deadband) and damping.

  dof frictionloss is a constraint row (as in MuJoCo), not a force here.
  """
  plan: Plan = m.plan["smooth"]
  qpos = d.qpos
  qfrc = -m.dof_damping * d.qvel

  jnt, qadr, vadr = plan.spring_lin
  if len(jnt) or len(plan.spring_ball[0]) or len(plan.spring_free[0]):
    spring = torch.zeros_like(qfrc)
    if len(jnt):
      spring[:, vadr] = -m.jnt_stiffness[jnt] * (
          qpos[:, qadr] - m.qpos_spring[qadr])
    ar3 = torch.arange(3, device=qpos.device)
    ar4 = torch.arange(4, device=qpos.device)
    jnt, qadr, vadr = plan.spring_ball
    if len(jnt):
      q4 = qadr[:, None] + ar4
      dif = math.quat_diff_vel(m.qpos_spring[q4], qpos[:, q4])
      spring[:, vadr[:, None] + ar3] = -m.jnt_stiffness[jnt, None] * dif
    jnt, qadr, vadr = plan.spring_free
    if len(jnt):
      stiff = -m.jnt_stiffness[jnt, None]
      q3 = qadr[:, None] + ar3
      spring[:, vadr[:, None] + ar3] = stiff * (qpos[:, q3]
                                                - m.qpos_spring[q3])
      q4 = qadr[:, None] + 3 + ar4
      dif = math.quat_diff_vel(m.qpos_spring[q4], qpos[:, q4])
      spring[:, vadr[:, None] + 3 + ar3] = stiff * dif
    qfrc = qfrc + spring

  if m.ntendon:
    lo = m.tendon_lengthspring[:, 0]
    hi = m.tendon_lengthspring[:, 1]
    length = d.ten_length
    displ = torch.where(length < lo, lo - length,
                        torch.where(length > hi, hi - length,
                                    torch.zeros_like(length)))
    frc = m.tendon_stiffness * displ - m.tendon_damping * d.ten_velocity
    qfrc = qfrc + math.fixed_vm(frc, d.ten_J)

  return d.replace(qfrc_passive=qfrc)

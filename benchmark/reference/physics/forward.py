"""Forward dynamics and the Euler integrator: the engine's `step`.

Stage order of MuJoCo's mj_forward / mj_step, as functions
(Model, Data) -> Data over a batch of envs. Always the fused path: the
Newton kernel returns qacc_smooth and the implicit-damping Euler
acceleration with the constraint solve, so no stage here factors qM.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.physics import (actuation, collision, constraint,
                                        kinematics, math, smooth, solver,
                                        tendon)
from benchmark.reference.physics.types import (Data, DynType,
                                              IntegratorType, JointType,
                                              Model, index_tensor)


class Plan(NamedTuple):
  lin_q: torch.Tensor          # qpos entries that integrate linearly
  lin_v: torch.Tensor          # ... and their dofs
  all_linear: bool             # every qpos entry is linear
  quat_q: torch.Tensor         # (nquat,) quaternion qpos addresses
  quat_v: torch.Tensor         # ... and their angular-velocity dofs
  muscle_act: torch.Tensor     # (na,) bool: activation of a muscle
  lim_act: torch.Tensor        # activations with an explicit actrange
  lim_act_u: torch.Tensor      # ... and their actuators


def make_plan(m: Model) -> Plan:
  lin_q, lin_v, quat_q, quat_v = [], [], [], []
  for j in range(m.njnt):
    jtype = int(m.jnt_type[j])
    qadr, vadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if jtype == JointType.FREE:
      lin_q += [qadr, qadr + 1, qadr + 2]
      lin_v += [vadr, vadr + 1, vadr + 2]
      quat_q.append(qadr + 3)
      quat_v.append(vadr + 3)
    elif jtype == JointType.BALL:
      quat_q.append(qadr)
      quat_v.append(vadr)
    else:
      lin_q.append(qadr)
      lin_v.append(vadr)

  muscle_act = np.zeros(m.na, dtype=bool)
  lim_act, lim_act_u = [], []
  for i in range(m.nu):
    adr = int(m.actuator_actadr[i])
    if adr < 0:
      continue
    if m.actuator_dyntype[i] == DynType.MUSCLE:
      muscle_act[adr] = True
    if m.actuator_actlimited[i]:
      lim_act.append(adr)
      lim_act_u.append(i)
  idx = lambda x: index_tensor(x, m.device)
  return Plan(lin_q=idx(lin_q), lin_v=idx(lin_v),
              all_linear=len(lin_q) == m.nq and not quat_q,
              quat_q=idx(quat_q), quat_v=idx(quat_v),
              muscle_act=torch.as_tensor(muscle_act, device=m.device),
              lim_act=idx(lim_act), lim_act_u=idx(lim_act_u))


def fwd_position(m: Model, d: Data) -> Data:
  d = kinematics.kinematics(m, d)
  d = kinematics.com_pos(m, d)
  d = tendon.tendon(m, d)
  d = actuation.transmission(m, d)
  d = smooth.crb(m, d)
  return collision.collision(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  d = kinematics.com_vel(m, d)
  d = tendon.tendon_velocity(m, d)
  d = actuation.actuator_velocity(m, d)
  d = smooth.rne(m, d)
  d = smooth.passive(m, d)
  return d


def fwd_actuation(m: Model, d: Data) -> Data:
  return actuation.actuation(m, d)


def xfrc_projection(m: Model, d: Data) -> torch.Tensor:
  """Project Cartesian body wrenches xfrc_applied into dof space."""
  kin = m.plan["kinematics"]
  offset = d.xipos - d.subtree_com[:, kin.root]         # (B, nbody, 3)
  frc = d.xfrc_applied
  cfrc = torch.cat([frc[..., 3:] + math.cross(offset, frc[..., :3]),
                    frc[..., :3]], -1)                   # (B, nbody, 6)
  per_body = math.fixed_mm(cfrc, d.cdof.transpose(-1, -2))  # (B, nbody, nv)
  return math.fixed_sum(per_body * kin.body_dof_mask, 1)


def fwd_acceleration(m: Model, d: Data) -> Data:
  """qfrc_smooth; qacc_smooth comes out of the fused solve."""
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                 + d.qfrc_applied + xfrc_projection(m, d))
  return d.replace(qfrc_smooth=qfrc_smooth)


def fwd_constraint(m: Model, d: Data) -> Data:
  efc = constraint.make_efc(m, d)
  qacc, qfrc_constraint, efc_force, a_smooth, qacc_euler = solver.solve(
      m, d, efc)
  d = d.replace(qacc=qacc, qfrc_constraint=qfrc_constraint,
                efc_force=efc_force, qacc_smooth=a_smooth,
                qacc_euler=qacc_euler)
  plan: constraint.Plan = m.plan["constraint"]
  if not plan.n_con:
    return d
  # per-contact normal force: the pyramidal edge forces of one contact sum
  # to its normal component
  return d.replace(contact_force=math.rows_apply(plan.con_force, efc_force,
                                                  1))


def solve_inputs(m: Model, d: Data):
  """The Newton kernel's arguments at the state d (the stages before the
  solve, then the constraint rows): the main path's own systems, for
  holding the kernel against its plain version."""
  for stage in (fwd_position, fwd_velocity, fwd_actuation, fwd_acceleration):
    d = stage(m, d)
  return solver.newton_inputs(m, d, constraint.make_efc(m, d))


def forward(m: Model, d: Data) -> Data:
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  d = fwd_constraint(m, d)
  return d


def _integrate_act(m: Model, d: Data, h: float) -> torch.Tensor:
  if m.na == 0:
    return d.act
  plan: Plan = m.plan["forward"]
  act = d.act + h * d.act_dot
  act = torch.where(plan.muscle_act, torch.clamp(act, 0.0, 1.0), act)
  if len(plan.lim_act):
    rng = m.actuator_actrange[plan.lim_act_u]
    act = act.clone()
    act[:, plan.lim_act] = torch.clamp(act[:, plan.lim_act], rng[:, 0],
                                       rng[:, 1])
  return act


def _integrate_qpos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                    h: float) -> torch.Tensor:
  """Position integration; ball and free-joint rotations stay unit
  quaternions."""
  plan: Plan = m.plan["forward"]
  if plan.all_linear:
    return qpos + h * qvel[:, plan.lin_v]
  out = qpos.clone()
  if len(plan.lin_q):
    out[:, plan.lin_q] = qpos[:, plan.lin_q] + h * qvel[:, plan.lin_v]
  if len(plan.quat_q):
    q4 = plan.quat_q[:, None] + torch.arange(4, device=qpos.device)
    v3 = plan.quat_v[:, None] + torch.arange(3, device=qpos.device)
    out[:, q4] = math.quat_integrate(qpos[:, q4], qvel[:, v3], h)
  return out


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (mj_Euler); the fused
  solve already gave (qM + h diag(damping))^-1 (qfrc_smooth + qfrc)."""
  h = m.opt.timestep
  act = _integrate_act(m, d, h)
  qvel = d.qvel + h * d.qacc_euler
  qpos = _integrate_qpos(m, d.qpos, qvel, h)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


_EULER_LIKE: Tuple[int, ...] = (IntegratorType.EULER,
                                IntegratorType.IMPLICITFAST,
                                IntegratorType.IMPLICIT)


def step(m: Model, d: Data) -> Data:
  """One physics step: forward dynamics + integration."""
  if m.opt.integrator not in _EULER_LIKE:
    raise NotImplementedError(f"integrator {m.opt.integrator}")
  return euler(m, forward(m, d))


def step_n(m: Model, d: Data, n: int) -> Data:
  """n physics substeps under one control (ctrl_dt / sim_dt)."""
  for _ in range(n):
    d = step(m, d)
  return d

"""Actuation: transmissions, activation dynamics and the muscle FLV model.

MuJoCo's muscle actuator semantics (force-length-velocity surface,
activation/deactivation time constants from actuator_dynprm) plus the
motor, position and velocity general actuators. Per-actuator work is one
batched pass over (env, actuator) with masks from the model's plan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.physics import math
from benchmark.reference.physics.types import (BiasType, Data, DynType,
                                              GainType, JointType, Model,
                                              TrnType, index_tensor)


class Plan(NamedTuple):
  joint_moment: torch.Tensor   # (nu, nv) constant moment of joint actuators
  len_qmap: math.FixedRows     # (nu, nq): length = map @ qpos
  ten_gather: torch.Tensor     # (nu,) tendon id per actuator
  ten_scale: torch.Tensor      # (nu,) gear0, 0 if not a tendon actuator
  ctrl_limited: torch.Tensor   # (nu,) bool
  force_limited: torch.Tensor
  has_act: torch.Tensor        # (nu,) bool: actuator has an activation
  act_gather: torch.Tensor     # (nu,) activation address (0 when none)
  act_src: torch.Tensor        # actuators with an activation
  act_dst: torch.Tensor        # ... and their activation addresses
  dyn_muscle: torch.Tensor     # (nu,) bool masks by type
  dyn_integrator: torch.Tensor
  dyn_filter: torch.Tensor
  gain_fixed: torch.Tensor
  gain_affine: torch.Tensor
  gain_muscle: torch.Tensor
  bias_affine: torch.Tensor
  bias_muscle: torch.Tensor
  any_muscle_dyn: bool         # host flags: skip the muscle curves when unused
  any_muscle_gain: bool
  any_muscle_bias: bool


def make_plan(m: Model) -> Plan:
  gear = m.actuator_gear.detach().cpu().numpy()
  joint_moment = np.zeros((m.nu, m.nv), dtype=np.float32)
  len_qmap = np.zeros((m.nu, m.nq), dtype=np.float32)
  ten_gather = np.zeros(m.nu, dtype=np.int64)
  ten_scale = np.zeros(m.nu, dtype=np.float32)
  for i in range(m.nu):
    trn = int(m.actuator_trntype[i])
    tid = int(m.actuator_trnid[i][0])
    if trn == TrnType.JOINT:
      jtype = int(m.jnt_type[tid])
      qadr, vadr = int(m.jnt_qposadr[tid]), int(m.jnt_dofadr[tid])
      if jtype in (JointType.SLIDE, JointType.HINGE):
        len_qmap[i, qadr] = gear[i, 0]
        joint_moment[i, vadr] = gear[i, 0]
      else:
        nd = 3 if jtype == JointType.BALL else 6
        joint_moment[i, vadr:vadr + nd] = gear[i, :nd]
    elif trn == TrnType.TENDON:
      ten_gather[i] = tid
      ten_scale[i] = gear[i, 0]
    else:
      raise NotImplementedError(f"actuator transmission {trn} not supported")

  dev = m.device
  mask = lambda x: torch.as_tensor(np.asarray(x, dtype=bool), device=dev)
  adr = np.asarray(m.actuator_actadr)
  has_act = adr >= 0
  src = np.nonzero(has_act)[0]
  dyn, gain, bias = (m.actuator_dyntype, m.actuator_gaintype,
                     m.actuator_biastype)
  return Plan(
      joint_moment=torch.as_tensor(joint_moment, device=dev),
      len_qmap=math.fixed_rows(len_qmap, dev),
      ten_gather=index_tensor(ten_gather, dev),
      ten_scale=torch.as_tensor(ten_scale, device=dev),
      ctrl_limited=mask(m.actuator_ctrllimited),
      force_limited=mask(m.actuator_forcelimited),
      has_act=mask(has_act),
      act_gather=index_tensor(np.where(has_act, adr, 0), dev),
      act_src=index_tensor(src, dev), act_dst=index_tensor(adr[src], dev),
      dyn_muscle=mask(dyn == DynType.MUSCLE),
      dyn_integrator=mask(dyn == DynType.INTEGRATOR),
      dyn_filter=mask((dyn == DynType.FILTER) | (dyn == DynType.FILTEREXACT)),
      gain_fixed=mask(gain == GainType.FIXED),
      gain_affine=mask(gain == GainType.AFFINE),
      gain_muscle=mask(gain == GainType.MUSCLE),
      bias_affine=mask(bias == BiasType.AFFINE),
      bias_muscle=mask(bias == BiasType.MUSCLE),
      any_muscle_dyn=bool((dyn == DynType.MUSCLE).any()),
      any_muscle_gain=bool((gain == GainType.MUSCLE).any()),
      any_muscle_bias=bool((bias == BiasType.MUSCLE).any()))


def transmission(m: Model, d: Data) -> Data:
  """actuator_length and dense actuator_moment (B, nu, nv)."""
  if m.nu == 0:
    return d
  plan: Plan = m.plan["actuation"]
  lengths = math.rows_apply(plan.len_qmap, d.qpos, 1)
  moment = plan.joint_moment.expand(d.batch, -1, -1)
  if m.ntendon:
    lengths = lengths + d.ten_length[:, plan.ten_gather] * plan.ten_scale
    moment = moment + d.ten_J[:, plan.ten_gather] * plan.ten_scale[:, None]
  return d.replace(actuator_length=lengths,
                   actuator_moment=moment.contiguous())


def actuator_velocity(m: Model, d: Data) -> Data:
  if m.nu == 0:
    return d
  return d.replace(actuator_velocity=math.fixed_mv(d.actuator_moment,
                                                    d.qvel))


# ---------------------------------------------------------------------------
# muscle curves (mju_muscleGain / mju_muscleBias / mju_muscleDynamics);
# `prm` rows are parameters, columns actuators
# ---------------------------------------------------------------------------


def _bump(length, a, mid, b):
  """Quartic spline bump: 0 at a and b, 1 at mid (MuJoCo FL curve)."""
  left = 0.5 * (a + mid)
  right = 0.5 * (mid + b)
  x_l = (length - a) / torch.clamp(left - a, min=1e-9)
  x_m1 = (mid - length) / torch.clamp(mid - left, min=1e-9)
  x_m2 = (length - mid) / torch.clamp(right - mid, min=1e-9)
  x_r = (b - length) / torch.clamp(b - right, min=1e-9)
  zero = torch.zeros_like(length)
  return torch.where(length <= a, zero,
         torch.where(length < left, 0.5 * x_l * x_l,
         torch.where(length < mid, 1.0 - 0.5 * x_m1 * x_m1,
         torch.where(length < right, 1.0 - 0.5 * x_m2 * x_m2,
         torch.where(length < b, 0.5 * x_r * x_r, zero)))))


def _max_force(prm, acc0):
  force, scale = prm[2], prm[3]
  return torch.where(force < 0, scale / torch.clamp(acc0, min=1e-9), force)


def _norm_length(length, lengthrange, prm):
  range0, range1 = prm[0], prm[1]
  l0 = (lengthrange[1] - lengthrange[0]) / torch.clamp(range1 - range0,
                                                       min=1e-9)
  return range0 + (length - lengthrange[0]) / torch.clamp(l0, min=1e-9), l0


def muscle_gain(length, vel, lengthrange, acc0, prm):
  """Active muscle gain: -F_max * FL(L) * FV(V)."""
  lmin, lmax, vmax, fvmax = prm[4], prm[5], prm[6], prm[8]
  force = _max_force(prm, acc0)
  l_n, l0 = _norm_length(length, lengthrange, prm)
  v_n = vel / torch.clamp(l0 * vmax, min=1e-9)
  fl = _bump(l_n, lmin, 1.0, lmax)
  y = fvmax - 1.0
  fv = torch.where(v_n <= -1.0, torch.zeros_like(v_n),
       torch.where(v_n <= 0.0, (v_n + 1.0) * (v_n + 1.0),
       torch.where(v_n <= y, fvmax - (y - v_n) * (y - v_n) /
                   torch.clamp(y, min=1e-9), fvmax.expand_as(v_n))))
  return -force * fl * fv


def muscle_bias(length, lengthrange, acc0, prm):
  """Passive muscle force: -F_max * FP(L)."""
  lmax, fpmax = prm[5], prm[7]
  force = _max_force(prm, acc0)
  l_n, _ = _norm_length(length, lengthrange, prm)
  b = 0.5 * (lmax + 1.0)
  x = (l_n - 1.0) / torch.clamp(b - 1.0, min=1e-9)
  fp = torch.where(l_n <= 1.0, torch.zeros_like(l_n),
       torch.where(l_n <= b, 0.25 * fpmax * x * x * x,
                   0.25 * fpmax * (1.0 + 3.0 * (l_n - b) /
                                   torch.clamp(b - 1.0, min=1e-9))))
  return -force * fp


def muscle_dynamics(ctrl, act, prm):
  """Activation dynamics with act-dependent time constants + smoothing."""
  tau_act, tau_deact, smooth_width = prm[0], prm[1], prm[2]
  c = torch.clamp(ctrl, 0.0, 1.0)
  tau_a = tau_act * (0.5 + 1.5 * act)
  tau_d = tau_deact / (0.5 + 1.5 * act)
  dctrl = c - act
  xc = torch.clamp(dctrl / torch.clamp(smooth_width, min=1e-9) + 0.5,
                   0.0, 1.0)
  # MuJoCo's quintic smoothstep on [0, 1]
  smooth = xc * xc * xc * (3.0 * xc * (2.0 * xc - 5.0) + 10.0)
  blend = torch.where(smooth_width < 1e-9, (dctrl > 0.0).to(act.dtype),
                      smooth)
  tau = blend * tau_a + (1.0 - blend) * tau_d
  return dctrl / torch.clamp(tau, min=1e-9)


def actuation(m: Model, d: Data) -> Data:
  """act_dot, actuator_force, qfrc_actuator (mj_fwdActuation)."""
  if m.nu == 0:
    return d
  plan: Plan = m.plan["actuation"]
  ctrl = torch.where(plan.ctrl_limited,
                     torch.clamp(d.ctrl, m.actuator_ctrlrange[:, 0],
                                 m.actuator_ctrlrange[:, 1]), d.ctrl)
  act_full = torch.zeros_like(ctrl)
  if m.na:
    act_full = torch.where(plan.has_act, d.act[:, plan.act_gather], act_full)

  dd = torch.zeros_like(ctrl)
  if plan.any_muscle_dyn:
    dd = torch.where(plan.dyn_muscle, muscle_dynamics(
        ctrl, act_full, m.actuator_dynprm.T), dd)
  dd = torch.where(plan.dyn_integrator, ctrl, dd)
  dd = torch.where(plan.dyn_filter, (ctrl - act_full) / torch.clamp(
      m.actuator_dynprm[:, 0], min=1e-9), dd)

  inp = torch.where(plan.has_act, act_full, ctrl)
  length, vel = d.actuator_length, d.actuator_velocity
  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  gain = torch.where(plan.gain_fixed, gp[:, 0], torch.zeros_like(ctrl))
  gain = torch.where(plan.gain_affine,
                     gp[:, 0] + gp[:, 1] * length + gp[:, 2] * vel, gain)
  lengthrange = m.actuator_lengthrange.T
  if plan.any_muscle_gain:
    gain = torch.where(plan.gain_muscle, muscle_gain(
        length, vel, lengthrange, m.actuator_acc0, gp.T), gain)
  bias = torch.where(plan.bias_affine,
                     bp[:, 0] + bp[:, 1] * length + bp[:, 2] * vel,
                     torch.zeros_like(ctrl))
  if plan.any_muscle_bias:
    bias = torch.where(plan.bias_muscle, muscle_bias(
        length, lengthrange, m.actuator_acc0, bp.T), bias)

  force = gain * inp + bias
  force = torch.where(plan.force_limited,
                      torch.clamp(force, m.actuator_forcerange[:, 0],
                                  m.actuator_forcerange[:, 1]), force)
  qfrc = math.fixed_vm(force, d.actuator_moment)

  act_dot = d.act_dot
  if m.na:
    act_dot = act_dot.clone()
    act_dot[:, plan.act_dst] = dd[:, plan.act_src]
  return d.replace(actuator_force=force, qfrc_actuator=qfrc, act_dot=act_dot)

"""Forward kinematics and CoM-frame quantities (mj_kinematics, mj_comPos,
mj_comVel), batched over envs.

Bodies are posed one tree level at a time (`Model.body_tree`): every body of
a level is done by one set of tensor ops, with the level's joints grouped by
slot and type. Subtree sums (subtree CoM) are products with the subtree
mask, and body velocities are products with the ancestor-dof masks built
here once per model, so neither walks the tree; each product sums in a
fixed order (`math.rows_apply`), whatever the batch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.physics import math
from benchmark.reference.physics.types import (Data, JointType, Model,
                                              index_tensor)


class _JointGroup(NamedTuple):
  jtype: int
  local: Optional[torch.Tensor]   # positions within the level; None = all
  jnt: torch.Tensor               # joint ids
  qadr: torch.Tensor


class _Level(NamedTuple):
  ids: torch.Tensor
  parent: torch.Tensor
  mocap: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (local, mocap id)
  joints: Tuple[_JointGroup, ...]


class _CdofGroup(NamedTuple):
  jtype: int
  jnt: torch.Tensor
  vadr: torch.Tensor
  body: torch.Tensor
  root: torch.Tensor


class Plan(NamedTuple):
  levels: Tuple[_Level, ...]
  cdof_groups: Tuple[_CdofGroup, ...]
  body_dof_mask: torch.Tensor   # (nbody, nv): dof is an ancestor dof of body
  body_dofs: math.FixedRows     # body_dof_mask's rows
  pre_vel: math.FixedRows       # (nv, nv): dofs in the velocity a dof sees
  subtree: math.FixedRows       # body_subtreemask's rows
  dof_dot_mask: torch.Tensor    # (nv,): 0 for free-joint translations
  geom_body: torch.Tensor
  site_body: torch.Tensor
  root: torch.Tensor            # (nbody,) kinematic root of each body


def make_plan(m: Model) -> Plan:
  dev = m.device
  idx = lambda x: index_tensor(x, dev)
  levels = []
  for ids in m.body_tree:
    ids = np.asarray(ids)
    mocap_local = [i for i, b in enumerate(ids) if m.body_mocapid[b] >= 0]
    mocap = None
    if mocap_local:
      mocap = (idx(mocap_local), idx(m.body_mocapid[ids[mocap_local]]))
    groups: List[_JointGroup] = []
    max_slots = int(m.body_jntnum[ids].max()) if len(ids) else 0
    for slot in range(max_slots):
      for jtype in JointType:
        local = [i for i, b in enumerate(ids)
                 if m.body_jntnum[b] > slot
                 and m.jnt_type[m.body_jntadr[b] + slot] == jtype]
        if not local:
          continue
        jnt = [int(m.body_jntadr[ids[i]]) + slot for i in local]
        groups.append(_JointGroup(
            jtype=int(jtype),
            local=None if len(local) == len(ids) else idx(local),
            jnt=idx(jnt), qadr=idx(m.jnt_qposadr[jnt])))
    levels.append(_Level(ids=idx(ids), parent=idx(m.body_parentid[ids]),
                         mocap=mocap, joints=tuple(groups)))

  cdof_groups = []
  for jtype in JointType:
    jnt = np.nonzero(m.jnt_type == jtype)[0]
    if len(jnt):
      body = m.jnt_bodyid[jnt]
      cdof_groups.append(_CdofGroup(
          jtype=int(jtype), jnt=idx(jnt), vadr=idx(m.jnt_dofadr[jnt]),
          body=idx(body), root=idx(m.body_rootid[body])))

  # which dofs make up each body's velocity, and the velocity each dof's
  # cdof_dot is taken against (mirrors mj_comVel's walk)
  body_dofs = [set() for _ in range(m.nbody)]
  pre = np.zeros((m.nv, m.nv), dtype=np.float32)
  dot_mask = np.ones(m.nv, dtype=np.float32)
  for b in range(1, m.nbody):
    v = set(body_dofs[int(m.body_parentid[b])])
    for j in range(int(m.body_jntadr[b]),
                   int(m.body_jntadr[b]) + int(m.body_jntnum[b])):
      jtype, vadr = int(m.jnt_type[j]), int(m.jnt_dofadr[j])
      if jtype == JointType.FREE:
        dot_mask[vadr:vadr + 3] = 0.0
        v |= {vadr, vadr + 1, vadr + 2}
        for i in range(3, 6):
          pre[vadr + i, list(v)] = 1.0
        v |= {vadr + 3, vadr + 4, vadr + 5}
      elif jtype == JointType.BALL:
        for i in range(3):
          pre[vadr + i, list(v)] = 1.0
        v |= {vadr, vadr + 1, vadr + 2}
      else:
        pre[vadr, list(v)] = 1.0
        v |= {vadr}
    body_dofs[b] = v
  dof_mask = np.zeros((m.nbody, m.nv), dtype=np.float32)
  for b, dofs in enumerate(body_dofs):
    dof_mask[b, list(dofs)] = 1.0

  f32 = lambda x: torch.as_tensor(x, device=dev)
  return Plan(levels=tuple(levels), cdof_groups=tuple(cdof_groups),
              body_dof_mask=f32(dof_mask),
              body_dofs=math.fixed_rows(dof_mask, dev),
              pre_vel=math.fixed_rows(pre, dev),
              subtree=math.fixed_rows(m.body_subtreemask.cpu().numpy(), dev),
              dof_dot_mask=f32(dot_mask), geom_body=idx(m.geom_bodyid),
              site_body=idx(m.site_bodyid), root=idx(m.body_rootid))


def kinematics(m: Model, d: Data) -> Data:
  """Body, joint, geom and site poses from qpos."""
  plan: Plan = m.plan["kinematics"]
  qpos = d.qpos
  B = qpos.shape[0]
  xpos = qpos.new_zeros(B, m.nbody, 3)
  xquat = qpos.new_zeros(B, m.nbody, 4)
  xquat[..., 0] = 1.0
  xanchor = qpos.new_zeros(B, m.njnt, 3)
  xaxis = qpos.new_zeros(B, m.njnt, 3)

  for lv in plan.levels:
    pq = xquat[:, lv.parent]
    pos = xpos[:, lv.parent] + math.rotate(m.body_pos[lv.ids], pq)
    quat = math.mul_quat(pq, m.body_quat[lv.ids])
    if lv.mocap is not None:
      local, mid = lv.mocap
      pos[:, local] = d.mocap_pos[:, mid]
      quat[:, local] = d.mocap_quat[:, mid]

    for g in lv.joints:
      p = pos if g.local is None else pos[:, g.local]
      q = quat if g.local is None else quat[:, g.local]
      if g.jtype == JointType.FREE:
        p = qpos[:, g.qadr[:, None] + torch.arange(3, device=qpos.device)]
        q = math.normalize(
            qpos[:, g.qadr[:, None] + torch.arange(3, 7, device=qpos.device)])
        anchor = p
        axis = m.jnt_axis[g.jnt].expand_as(p)
      else:
        jpos, jaxis = m.jnt_pos[g.jnt], m.jnt_axis[g.jnt]
        anchor = math.rotate(jpos, q) + p
        axis = math.rotate(jaxis, q)
        if g.jtype == JointType.SLIDE:
          p = p + axis * (qpos[:, g.qadr] - m.qpos0[g.qadr])[..., None]
        elif g.jtype == JointType.HINGE:
          q = math.mul_quat(q, math.axis_angle_to_quat(
              jaxis, qpos[:, g.qadr] - m.qpos0[g.qadr]))
          p = anchor - math.rotate(jpos, q)
        else:  # BALL
          qloc = math.normalize(
              qpos[:, g.qadr[:, None] + torch.arange(4, device=qpos.device)])
          q = math.mul_quat(q, qloc)
          p = anchor - math.rotate(jpos, q)
      if g.local is None:
        pos, quat = p, q
      else:
        pos[:, g.local] = p
        quat[:, g.local] = q
      xanchor[:, g.jnt] = anchor
      xaxis[:, g.jnt] = axis

    xpos[:, lv.ids] = pos
    xquat[:, lv.ids] = quat

  xmat = math.quat_to_mat(xquat)
  xipos = xpos + math.rotate(m.body_ipos, xquat)
  ximat = math.quat_to_mat(math.mul_quat(xquat, m.body_iquat))

  geom_xpos, geom_xmat = d.geom_xpos, d.geom_xmat
  if m.ngeom:
    gq = xquat[:, plan.geom_body]
    geom_xpos = xpos[:, plan.geom_body] + math.rotate(m.geom_pos, gq)
    geom_xmat = math.quat_to_mat(math.mul_quat(gq, m.geom_quat))
  site_xpos, site_xmat = d.site_xpos, d.site_xmat
  if m.nsite:
    sq = xquat[:, plan.site_body]
    site_xpos = xpos[:, plan.site_body] + math.rotate(m.site_pos, sq)
    site_xmat = math.quat_to_mat(math.mul_quat(sq, m.site_quat))

  return d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                   ximat=ximat, xanchor=xanchor, xaxis=xaxis,
                   geom_xpos=geom_xpos, geom_xmat=geom_xmat,
                   site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: Model, d: Data) -> Data:
  """Subtree CoM, CoM-frame inertia (cinert) and dof axes (cdof). The
  masses (nbody,) and inertias (nbody, 3) may carry a leading env axis (a
  per-env model)."""
  plan: Plan = m.plan["kinematics"]
  mass = m.body_mass
  wmass = mass[..., None] * d.xipos
  subtree_mass = math.rows_apply(plan.subtree, mass, -1)
  subtree_com = (math.rows_apply(plan.subtree, wmass, -2)
                 / torch.clamp(subtree_mass, min=1e-12)[..., None])
  root_com = subtree_com[:, plan.root]

  # R diag(i) R^T and the parallel-axis shift to the root's subtree CoM
  ximat = d.ximat
  imat_w = (ximat[..., :, None, :] * ximat[..., None, :, :]
            * m.body_inertia[..., None, None, :]).sum(-1)
  dvec = d.xipos - root_com
  eye = torch.eye(3, dtype=dvec.dtype, device=dvec.device)
  i_off = imat_w + mass[..., None, None] * (
      math.dot(dvec, dvec)[..., None, None] * eye
      - dvec[..., :, None] * dvec[..., None, :])
  cinert = torch.cat([
      torch.stack([i_off[..., 0, 0], i_off[..., 1, 1], i_off[..., 2, 2],
                   i_off[..., 0, 1], i_off[..., 0, 2], i_off[..., 1, 2]], -1),
      mass[..., None] * dvec, mass.expand_as(dvec[..., 0])[..., None]],
      dim=-1)

  cdof = d.cdof.new_zeros(d.cdof.shape)
  for g in plan.cdof_groups:
    com = subtree_com[:, g.root]
    if g.jtype == JointType.HINGE:
      ang = d.xaxis[:, g.jnt]
      off = d.xanchor[:, g.jnt] - com
      cdof[:, g.vadr] = torch.cat([ang, math.cross(ang, -off)], -1)
    elif g.jtype == JointType.SLIDE:
      cdof[:, g.vadr] = torch.cat([torch.zeros_like(d.xaxis[:, g.jnt]),
                                   d.xaxis[:, g.jnt]], -1)
    else:
      first = 0
      if g.jtype == JointType.FREE:
        off = d.xpos[:, g.body] - com
        for i in range(3):
          e = torch.zeros_like(off)
          e[..., i] = 1.0
          cdof[:, g.vadr + i] = torch.cat([torch.zeros_like(e), e], -1)
        first = 3
      else:
        off = d.xanchor[:, g.jnt] - com
      for i in range(3):
        ang = d.xmat[:, g.body, :, i]
        cdof[:, g.vadr + first + i] = torch.cat(
            [ang, math.cross(ang, -off)], -1)

  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: Model, d: Data) -> Data:
  """Body spatial velocities cvel and dof-axis derivatives cdof_dot."""
  plan: Plan = m.plan["kinematics"]
  cq = d.cdof * d.qvel[..., None]                      # (B, nv, 6)
  cvel = math.rows_apply(plan.body_dofs, cq, 1)        # (B, nbody, 6)
  vpre = math.rows_apply(plan.pre_vel, cq, 1)          # (B, nv, 6)
  cdof_dot = math.motion_cross(vpre, d.cdof) * plan.dof_dot_mask[:, None]
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)

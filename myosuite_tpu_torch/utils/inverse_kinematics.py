"""Inverse kinematics: damped least squares posing of a site, batched.

The JAX package's `qpos_from_site_pose` (dm_control lineage): iterate
joint angles that place a site at a target position (and orientation),
with Tikhonov damping and a cap on each step's norm. The JAX function runs
a `lax.while_loop` per env under vmap; here a batch of envs runs
`max_steps` iterations with a per-env `active` mask, so an env that has
converged (or used up its steps) keeps its qpos, err_norm and step count,
and no iteration reads anything back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from myosuite_tpu_torch.physics import kinematics, math
from myosuite_tpu_torch.physics.types import Data, Model


class IKResult(NamedTuple):
  qpos: torch.Tensor       # (B, nq)
  err_norm: torch.Tensor   # (B,)
  steps: torch.Tensor      # (B,) int32


def _site_err_and_jac(m: Model, d: Data, qpos: torch.Tensor, site_id: int,
                      target_pos: torch.Tensor,
                      target_quat: Optional[torch.Tensor]):
  """(error (B, 3 or 6), Jacobian (B, 3 or 6, nv)) of the site at qpos."""
  dd = kinematics.com_pos(m, kinematics.kinematics(m, d.replace(qpos=qpos)))
  plan = m.plan["kinematics"]
  body = int(m.site_bodyid[site_id])
  mask = plan.body_dof_mask[body][:, None]                    # (nv, 1)
  pos = dd.site_xpos[:, site_id]                              # (B, 3)
  com = dd.subtree_com[:, int(m.body_rootid[body])]
  cdof = dd.cdof                                              # (B, nv, 6)
  jacp = (math.cross(cdof[..., :3], (pos - com)[:, None, :])
          + cdof[..., 3:]) * mask
  err, jac = target_pos - pos, jacp.transpose(1, 2)
  if target_quat is not None:
    cur = math.mat_to_quat(dd.site_xmat[:, site_id])
    err = torch.cat([err, math.quat_diff_vel(cur, target_quat)], -1)
    jac = torch.cat([jac, (cdof[..., :3] * mask).transpose(1, 2)], 1)
  return err, jac


def qpos_from_site_pose(m: Model, d: Data, site_id: int,
                        target_pos: torch.Tensor,
                        target_quat: Optional[torch.Tensor] = None,
                        max_steps: int = 50,
                        damping: float = 0.05,
                        max_update_norm: float = 2.0,
                        tol: float = 1e-5) -> IKResult:
  """Joint angles placing `site_id` at target_pos (B, 3), and at
  target_quat (B, 4) if given, from each env's d.qpos. Each iteration:
  dq = J^T (J J^T + damping I)^-1 err, scaled down to max_update_norm,
  qpos + dq clipped to jnt_range; an env stops once err_norm <= tol."""
  def at(qpos):
    return _site_err_and_jac(m, d, qpos, site_id, target_pos, target_quat)

  qpos = d.qpos
  err, jac = at(qpos)
  err_norm = math.norm_safe(err)
  steps = torch.zeros(qpos.shape[0], dtype=torch.int32, device=qpos.device)
  eye = damping * torch.eye(jac.shape[1], dtype=jac.dtype, device=jac.device)
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  for _ in range(max_steps):
    active = err_norm > tol
    jjt = torch.matmul(jac, jac.transpose(1, 2)) + eye
    dq = torch.matmul(jac.transpose(1, 2),
                      torch.linalg.solve(jjt, err)[..., None])[..., 0]
    norm = math.norm_safe(dq)[:, None]
    dq = torch.where(norm > max_update_norm, dq * max_update_norm / norm, dq)
    # hinge and slide models: qpos and qvel aligned
    new = torch.clamp(qpos + dq, lo, hi)
    new_err, new_jac = at(new)
    keep = active[:, None]
    qpos = torch.where(keep, new, qpos)
    err = torch.where(keep, new_err, err)
    jac = torch.where(keep[..., None], new_jac, jac)
    err_norm = torch.where(active, math.norm_safe(new_err), err_norm)
    steps = steps + active.to(torch.int32)
  return IKResult(qpos=qpos, err_norm=err_norm, steps=steps)

"""Primal Newton constraint solver (MuJoCo-style soft constraints).

Minimizes  C(a) = 1/2 (a - a_smooth)^T M (a - a_smooth) + sum_i s_i(J_i a - aref_i)
where s_i is a one-sided quadratic (limits) or a Huber-style bounded
quadratic (dof friction loss), with fixed iteration counts (opt.iterations
Newton steps, opt.ls_iterations exact 1-D Newton line-search steps) and no
host control flow.

`solve` always takes the fused path: the Newton kernel (newton_kernel.py)
also returns qacc_smooth and the implicit-damping Euler acceleration, so the
step never factors qM elsewhere. `newton_kernel.route` picks the kernel by
(nv, nefc): the warp kernel (one warp per env) for nv <= 40 where an env
fits in its shared memory, the wide kernel (one block per env) for every
other shape, so every system the JAX package steps is solved.
`newton_torch` is the batched counterpart of the JAX package's
`newton_xla`, with `linalg`'s NaN-on-non-PD Cholesky.
"""

from __future__ import annotations

from typing import Tuple

import torch

from myosuite_tpu_torch.physics import linalg, newton_kernel
from myosuite_tpu_torch.physics.constraint import Efc
from myosuite_tpu_torch.physics.types import Data, Model

_RIDGE = 1e-8


def _is_friction(efc: Efc) -> torch.Tensor:
  return torch.arange(efc.J.shape[1], device=efc.J.device) < efc.n_friction


def _forces(efc: Efc, jar: torch.Tensor):
  """Per-row constraint force and curvature weight at this jar."""
  isfr = _is_friction(efc)
  quad_f = -jar / efc.R
  lim_active = efc.active & (jar < 0.0)
  zero = torch.zeros_like(jar)
  lim_force = torch.where(lim_active, quad_f, zero)
  lim_w = torch.where(lim_active, 1.0 / efc.R, zero)
  fr_force = torch.minimum(torch.maximum(quad_f, -efc.floss), efc.floss)
  fr_w = torch.where(quad_f.abs() < efc.floss, 1.0 / efc.R, zero)
  return (torch.where(isfr, fr_force, lim_force),
          torch.where(isfr, fr_w, lim_w))


def _cost(efc: Efc, jar: torch.Tensor) -> torch.Tensor:
  quad = 0.5 * jar * jar / efc.R
  lim_cost = torch.where(efc.active & (jar < 0.0), quad,
                         torch.zeros_like(quad))
  band = efc.floss * efc.R
  fr_cost = torch.where(jar.abs() < band, quad,
                        efc.floss * jar.abs() - 0.5 * efc.floss * band)
  return torch.where(_is_friction(efc), fr_cost, lim_cost).sum(-1)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  return torch.matmul(A, x[..., None])[..., 0]


def newton_torch(qM: torch.Tensor, efc: Efc, warm: torch.Tensor,
                 a_smooth: torch.Tensor, iterations: int, ls_iterations: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Batched Newton solve in plain PyTorch; returns (qacc,
  qfrc_constraint, efc_force)."""
  J = efc.J
  Jt = J.transpose(-1, -2)

  def total_cost(a):
    da = a - a_smooth
    return 0.5 * (da * _mv(qM, da)).sum(-1) + _cost(efc, _mv(J, a) - efc.aref)

  a = torch.where((total_cost(warm) < total_cost(a_smooth))[:, None], warm,
                  a_smooth)
  eye = torch.eye(qM.shape[-1], dtype=qM.dtype, device=qM.device)
  for _ in range(int(iterations)):
    jar = _mv(J, a) - efc.aref
    force, w = _forces(efc, jar)
    grad = _mv(qM, a - a_smooth) - _mv(Jt, force)
    hess = qM + torch.matmul(Jt * w[:, None, :], J) + _RIDGE * eye
    p = -linalg.solve_pd(hess, grad)

    jp = _mv(J, p)
    g0 = (p * _mv(qM, a - a_smooth)).sum(-1)
    pmp = (p * _mv(qM, p)).sum(-1)
    alpha = torch.ones_like(g0)
    for _ in range(int(ls_iterations)):
      force_a, w_a = _forces(efc, jar + alpha[:, None] * jp)
      dphi = g0 + alpha * pmp - (force_a * jp).sum(-1)
      ddphi = pmp + (w_a * jp * jp).sum(-1)
      alpha = torch.clamp(alpha - dphi / torch.clamp(ddphi, min=1e-12),
                          0.0, 4.0)
    a_new = a + alpha[:, None] * p
    a = torch.where((total_cost(a_new) <= total_cost(a))[:, None], a_new, a)

  force, _ = _forces(efc, _mv(J, a) - efc.aref)
  return a, _mv(Jt, force), force


def newton_inputs(m: Model, d: Data, efc: Efc):
  """The Newton kernel's arguments for this substep: (tensors, options)."""
  damph = (m.opt.timestep * m.dof_damping).expand(d.batch, -1)
  args = tuple(x.contiguous() for x in (
      d.qM, efc.J, efc.aref, efc.R, efc.floss, efc.active.to(d.qM.dtype),
      d.qacc, d.qfrc_smooth, damph))
  return args, dict(n_friction=efc.n_friction, iterations=m.opt.iterations,
                    ls_iterations=m.opt.ls_iterations)


def solve(m: Model, d: Data, efc: Efc):
  """Returns (qacc, qfrc_constraint, efc_force, qacc_smooth, qacc_euler).

  CUDA tensors go through the Newton kernel of `newton_kernel.route`
  ("warp" or "wide"), CPU tensors through its plain version. A model
  with no constraint rows needs no Newton solve: its two Cholesky solves
  run here in plain PyTorch.
  """
  if efc.J.shape[1] == 0:
    damph = (m.opt.timestep * m.dof_damping).expand(d.batch, -1)
    a_smooth = linalg.solve_pd(d.qM, d.qfrc_smooth)
    qacc_euler = linalg.solve_pd(d.qM + torch.diag_embed(damph),
                                 d.qfrc_smooth)
    return (a_smooth, torch.zeros_like(a_smooth), efc.aref, a_smooth,
            qacc_euler)
  args, kw = newton_inputs(m, d, efc)
  return newton_kernel.newton_solve(*args, **kw)

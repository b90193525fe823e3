"""Primal Newton constraint solver (MuJoCo-style soft constraints).

Minimizes  C(a) = 1/2 (a - a_smooth)^T M (a - a_smooth) + sum_i s_i(J_i a - aref_i)
where s_i is a one-sided quadratic (limits) or a Huber-style bounded
quadratic (dof friction loss), with fixed iteration counts (opt.iterations
Newton steps, opt.ls_iterations exact 1-D Newton line-search steps) and no
host control flow.

`solve` always takes the fused path: the plain Newton solve
(`newton_plain.py`) also returns qacc_smooth and the implicit-damping
Euler acceleration, so the step never factors qM elsewhere.
"""

from __future__ import annotations

import torch

from benchmark.reference.physics import linalg, newton_plain
from benchmark.reference.physics.constraint import Efc
from benchmark.reference.physics.types import Data, Model


def newton_inputs(m: Model, d: Data, efc: Efc):
  """The Newton solve's arguments for this substep: (tensors, options)."""
  damph = (m.opt.timestep * m.dof_damping).expand(d.batch, -1)
  args = tuple(x.contiguous() for x in (
      d.qM, efc.J, efc.aref, efc.R, efc.floss, efc.active.to(d.qM.dtype),
      d.qacc, d.qfrc_smooth, damph))
  return args, dict(n_friction=efc.n_friction, iterations=m.opt.iterations,
                    ls_iterations=m.opt.ls_iterations)


def solve(m: Model, d: Data, efc: Efc):
  """Returns (qacc, qfrc_constraint, efc_force, qacc_smooth, qacc_euler).

  Every device goes through the plain Newton solve. A model
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
  return newton_plain.newton_solve(*args, **kw)

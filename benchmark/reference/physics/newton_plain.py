"""The plain Newton solve: a frozen copy of the program's plain version
of its Newton kernels, for every device.

Fused smooth + Newton + implicit-Euler solve of a batch of systems, every
sum taken in a fixed order with no multiply-add contraction, so that a
kernel written to the same order agrees with it bit for bit. The pivots
of every Cholesky are clamped at 1e-12 (a negative pivot gives a finite
result, not NaN).
"""

from __future__ import annotations

import torch

_EPS = 1e-12
_RIDGE = 1e-8


# Every sum below is taken in a fixed order with no multiply-add
# contraction. That matters on the myoHand: its light finger
# dofs leave the Newton objective flat to float32 resolution over whole
# rad/s^2 of qacc, where two summation orders would let the accept tests
# stop at different points of equal cost.


def _wsum(x: torch.Tensor) -> torch.Tensor:
  """Sum over the last axis as the kernel's warp does: lane l accumulates
  entries l, l + 32, ..., then a butterfly over the 32 lanes. Lanes past the
  last entry hold 0, and adding 0 changes no sum, so they are left out."""
  lanes = x[..., :32]
  for c in range(32, x.shape[-1], 32):
    chunk = x[..., c:c + 32]
    lanes = torch.cat([lanes[..., :chunk.shape[-1]] + chunk,
                       lanes[..., chunk.shape[-1]:]], -1)
  for o in (16, 8, 4, 2, 1):
    w = lanes.shape[-1]
    if w <= o:
      continue
    lanes = torch.cat([lanes[..., :w - o] + lanes[..., o:],
                       lanes[..., w - o:o]], -1)
  return lanes[..., 0]


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """A x, each row summed over k in order (the kernel's `matvec`)."""
  s = torch.zeros_like(A[..., 0])
  for k in range(A.shape[-1]):
    s = s + A[..., k] * x[..., k:k + 1]
  return s


def _live_rows(x: torch.Tensor):
  """The rows e of x (B, nefc) that are nonzero in some env. A row whose
  factor is 0 adds +-0 to a sum that starts at +0, which changes no bit, so
  the kernels skip such rows and the sums here need not visit them."""
  return torch.nonzero((x != 0).any(0)).flatten().tolist()


def _mtv(A: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """A^T f, each column summed over rows in order (the kernel's `rows_t`)."""
  s = torch.zeros_like(A[..., 0, :])
  for e in _live_rows(f):
    s = s + A[..., e, :] * f[..., e:e + 1]
  return s


def _chol_factor(M: torch.Tensor) -> torch.Tensor:
  """Cholesky with every pivot clamped at 1e-12; the factor's diagonal is
  s / sqrt(max(s, 1e-12)) (Pallas kernel semantics). Right-looking, like
  the kernel's register tile: entry (i, j) subtracts L_ik L_jk over k
  ascending."""
  n = M.shape[-1]
  S = M.clone()
  L = torch.zeros_like(M)
  for k in range(n):
    d = torch.sqrt(torch.clamp(S[..., k, k], min=_EPS))
    L[..., k:, k] = S[..., k:, k] / d[..., None]
    c = L[..., k + 1:, k]
    S[..., k + 1:, k + 1:] = S[..., k + 1:, k + 1:] - c[..., :, None] * \
        c[..., None, :]
  return L


def _chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """(L L^T)^-1 b, column by column as the kernel's `chol_solve`."""
  n = b.shape[-1]
  s = b.clone()
  for i in range(n):
    s[..., i] = s[..., i] / L[..., i, i]
    s[..., i + 1:] = s[..., i + 1:] - L[..., i + 1:, i] * s[..., i:i + 1]
  for i in reversed(range(n)):
    s[..., i] = s[..., i] / L[..., i, i]
    s[..., :i] = s[..., :i] - L[..., i, :i] * s[..., i:i + 1]
  return s


def newton_solve_reference(qM, J, aref, R, floss, active, warm, qfrc_smooth,
                           damph, n_friction: int, iterations: int,
                           ls_iterations: int):
  """Plain PyTorch version of the kernel, batched; same arguments and
  results as `newton_solve`."""
  nefc = J.shape[1]
  rinv = 1.0 / R
  active = active.to(qM.dtype)
  isfr = torch.arange(nefc, device=qM.device) < n_friction

  def forces(jar):
    quad_f = -jar * rinv
    lim_on = active * (jar < 0.0).to(jar.dtype)
    if n_friction == 0:
      return lim_on * quad_f, lim_on * rinv
    fr_force = torch.minimum(torch.maximum(quad_f, -floss), floss)
    fr_w = (quad_f.abs() < floss).to(jar.dtype) * rinv
    return (torch.where(isfr, fr_force, lim_on * quad_f),
            torch.where(isfr, fr_w, lim_on * rinv))

  def total_cost(a):
    """(cost, J a - aref, qM (a - a_smooth)); the kernel's total_cost."""
    da = a - a_smooth
    mda = _mv(qM, da)
    jar = _mv(J, a) - aref
    quad = 0.5 * jar * jar * rinv
    band = floss / torch.clamp(rinv, min=_EPS)
    fr_cost = torch.where(jar.abs() < band, quad,
                          floss * jar.abs() - 0.5 * floss * band)
    lim_cost = torch.where((active != 0) & (jar < 0.0), quad,
                           torch.zeros_like(quad))
    cost = (0.5 * _wsum(da * mda)
            + _wsum(torch.where(isfr, fr_cost, lim_cost)))
    return cost, jar, mda

  def pick(take, new, old):
    return tuple(torch.where(take.view(-1, *[1] * (n.dim() - 1)), n, o)
                 for n, o in zip(new, old))

  a_smooth = _chol_solve(_chol_factor(qM), qfrc_smooth)
  # the current point with its cost, J a - aref and qM (a - a_smooth),
  # carried from the test that chose it, as the kernel does
  cost_w, jar_w, mda_w = total_cost(warm)
  cost_s, jar_s, mda_s = total_cost(a_smooth)
  a, cost, jar, mda = pick(cost_w < cost_s, (warm, cost_w, jar_w, mda_w),
                           (a_smooth, cost_s, jar_s, mda_s))

  eye_ridge = _RIDGE * torch.eye(qM.shape[-1], dtype=qM.dtype,
                                 device=qM.device)
  for _ in range(iterations):
    force, w = forces(jar)
    grad = mda - _mtv(J, force)
    jwj = torch.zeros_like(qM)
    for e in _live_rows(w):
      jwj = jwj + (J[:, e, :, None] * w[:, e, None, None]) * J[:, e, None, :]
    p = -_chol_solve(_chol_factor(jwj + qM + eye_ridge), grad)

    jp = _mv(J, p)
    g0 = _wsum(p * mda)
    pmp = _wsum(p * _mv(qM, p))
    alpha = torch.ones_like(g0)
    for _ in range(ls_iterations):
      force_a, w_a = forces(jar + alpha[:, None] * jp)
      sf, sw = _wsum(torch.stack([force_a * jp, w_a * jp * jp]))
      dphi = g0 + alpha * pmp - sf
      ddphi = pmp + sw
      alpha = torch.clamp(alpha - dphi / torch.clamp(ddphi, min=_EPS),
                          0.0, 4.0)
    a_new = a + alpha[:, None] * p
    cost_new, jar_new, mda_new = total_cost(a_new)
    a, cost, jar, mda = pick(cost_new <= cost,
                             (a_new, cost_new, jar_new, mda_new),
                             (a, cost, jar, mda))

  force, _ = forces(jar)
  qfrc = _mtv(J, force)
  mh = qM + torch.diag_embed(damph)
  qacc_euler = _chol_solve(_chol_factor(mh), qfrc_smooth + qfrc)
  return a, qfrc, force, a_smooth, qacc_euler


def newton_solve(qM, J, aref, R, floss, active, warm, qfrc_smooth, damph,
                 n_friction: int, iterations: int, ls_iterations: int):
  """Args lead with the env axis: qM (B,nv,nv), J (B,nefc,nv), aref, R,
  floss, active (B,nefc) (active as float 0/1), warm, qfrc_smooth, damph
  (B,nv). Rows [0, n_friction) are friction rows. Returns (qacc,
  qfrc_constraint, efc_force, qacc_smooth, qacc_euler)."""
  return newton_solve_reference(qM, J, aref, R, floss, active, warm,
                                qfrc_smooth, damph, n_friction=n_friction,
                                iterations=iterations,
                                ls_iterations=ls_iterations)

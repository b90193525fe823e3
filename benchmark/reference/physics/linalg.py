"""Small dense linear algebra for batches of (n, n) systems.

Semantics of the JAX package's `physics/linalg.py`: a left-looking Cholesky
whose pivots are clamped when they are float32 round-off (slightly negative
relative to the matrix scale), while a genuinely non-PD input gives NaN in
the affected column, so a physics blowup surfaces as NaN state.

On the step path these run only when a model has no constraint rows
(`solver.solve`'s nefc == 0 branch); the Newton kernel carries its own
clamped factorization (`newton_kernel.py`).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def chol_factor(M: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of (..., n, n) PD matrices, one column a step."""
  n = M.shape[-1]
  L = torch.zeros_like(M)
  diag = torch.diagonal(M, dim1=-2, dim2=-1)
  noise_floor = -1e-5 * diag.abs().amax(-1)
  for j in range(n):
    s = M[..., j:, j]
    if j:
      s = s - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
    pivot = s[..., 0]
    djj = torch.where(pivot > noise_floor,
                      torch.sqrt(torch.clamp(pivot, min=_EPS)),
                      torch.full_like(pivot, float("nan")))
    L[..., j:, j] = s / djj[..., None]
  return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L y = b by forward substitution; b: (..., n)."""
  n = L.shape[-1]
  y = torch.zeros_like(b)
  for i in range(n):
    s = b[..., i]
    if i:
      s = s - (L[..., i, :i] * y[..., :i]).sum(-1)
    y[..., i] = s / L[..., i, i]
  return y


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Solve L^T x = y by back substitution; L lower."""
  n = L.shape[-1]
  x = torch.zeros_like(y)
  for i in reversed(range(n)):
    s = y[..., i]
    if i < n - 1:
      s = s - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)
    x[..., i] = s / L[..., i, i]
  return x


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return solve_upper_t(L, solve_lower(L, b))


def solve_pd(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve M x = b for symmetric positive-definite M."""
  return chol_solve(chol_factor(M), b)

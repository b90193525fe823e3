"""The yardstick: the operations and bytes of the Newton solve, and the
card's published peaks.

A frozen copy of the program's cost model of its Newton kernels. It counts
what the algorithm needs for one env's launch, from the shapes of the
inputs (nv dofs, nefc constraint rows), the iteration counts the
configuration sets (Newton and line-search iterations) and the rows that
the solution weights: a multiply-add is 2 operations; Cholesky nv^3/3, a
triangular solve pair 2 nv^2, a mat-vec 2 nv^2, J x 2 nefc nv; each input
byte is read once and each output byte written once. It ignores how a
kernel does the work (its tiles, its re-reads, its padding), so the same
solve reads the same count whatever implements it, and a share of the
roofline above 100% means that the count or the time is wrong.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, published dense peaks at its 700 W limit
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def flops_per_env(nv: int, nefc: int, iterations: int, ls_iterations: int,
                  n_weighted: float) -> float:
  """FP32 operations one env needs per launch. A row of weight 0 adds
  nothing to J^T W J or to J^T f, so those count only the `n_weighted`
  rows the solution weights (`weighted_rows`). The Hessian is symmetric, so
  J^T W J counts its lower triangle, n_weighted nv (nv + 1). The warm start
  evaluates two costs; each iteration one, at the new point."""
  chol = nv ** 3 // 3
  solve = 2 * nv * nv
  matvec = 2 * nv * nv
  rows = 2 * nefc * nv
  nw = n_weighted
  rows_t = 2 * nw * nv
  cost = matvec + 2 * nv + rows + 6 * nefc
  per_iter = (rows_t + nv                        # grad
              + nw * nv * (nv + 1) + nv * (nv + 1) // 2 + chol + solve
              + rows + matvec + 4 * nv           # J p, qM p, g0, pmp
              + 10 * nefc * ls_iterations + 2 * nv + cost)
  outside = 3 * (chol + solve) + 2 * cost + rows_t + nv
  return outside + iterations * per_iter


def weighted_rows(force: torch.Tensor, n_friction: int) -> float:
  """Mean rows per env that J^T W J and J^T f need at the solution (the
  row forces a launch returns): every friction row, and each limit or
  contact row that pushes."""
  return n_friction + float((force[:, n_friction:] != 0).sum(1).double()
                            .mean())


def bytes_per_env(nv: int, nefc: int) -> int:
  """Device bytes one env must move: qM, J, 4 row vectors and 3 dof
  vectors in; 4 dof vectors and the row forces out, in float32."""
  return 4 * (nv * nv + nefc * nv + 4 * nefc + 3 * nv + 4 * nv + nefc)


def bound_seconds(batch: int, nv: int, nefc: int, iterations: int,
                  ls_iterations: int, n_weighted: float):
  """(least seconds a launch of `batch` envs can take on the card, the
  operations, the bytes): the larger of operations over the FP32 peak and
  bytes over the memory bandwidth."""
  ops = batch * flops_per_env(nv, nefc, iterations, ls_iterations,
                              n_weighted)
  nbytes = batch * bytes_per_env(nv, nefc)
  return max(ops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES_PER_S), ops, \
      nbytes

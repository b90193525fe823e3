"""The fused Newton-solver kernels: their build, their wrapper, their plain
version.

Two CUDA kernels replace the JAX package's Pallas TPU kernel
`pallas_solver.py::_solver_kernel`; `route(nv, nefc)` picks one by shape.
Each launch, once per substep, does the smooth solve, the whole Newton
constraint solve and the implicit-damping Euler solve for every env.

- "warp" (`csrc/newton_solver.cu`): one warp per env, for nv <= 40 where
  one env's working set fits in shared memory. Its function is FP32
  arithmetic (25-32 flops per byte of device traffic at nv = nefc = 23,
  above the H100's ~20 flops per byte FP32 ridge); the kernel is held back
  by each warp's chain of dependent shuffles, square roots and divisions,
  which its design (a register tile over all 32 lanes for J^T W J and the
  Cholesky, only the rows of nonzero weight or force, the accepted point
  carried between iterations) keeps short; see the source.
- "wide" (`csrc/newton_solver_wide.cu`): one block of 128 threads per env,
  for every other shape: nv > 40, or rows past the warp kernel's shared
  memory. Its Cholesky goes by entries over all four warps, one block
  barrier a column, its row evaluations too, and 8 envs share an SM at the
  cluttered Relocate's (45, 375); see the source. Its working set lives in
  shared memory where it fits, else in a per-env workspace in device
  memory, so it has no limit of its own.

`newton_solve` dispatches on the route and on the device of its inputs:
CUDA tensors go to the route's kernel (or raise), CPU tensors to its plain
PyTorch version. Both kernels take every sum in the same order, so one
plain version, `newton_solve_reference`, written step for step like them,
serves both (`newton_solve_wide_reference` names it for the wide route):
the same clamped Cholesky (pivots clamped at 1e-12: a negative pivot gives
a finite result, not NaN) and the same order of every sum. `launches` and
`launches_wide` count each kernel's launches.

The kernels are compiled with `nvcc` into `_build/` at first use, keyed by
a hash of their source and flags, and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

import numpy as np
import torch

MAX_NV = 40            # lane r holds dofs r and r + 32 (the TI 5 tile)
ENVS_PER_BLOCK = 8     # warps (envs) per block
_SMEM_LIMIT = 232448   # dynamic shared memory a block may use on sm_90
_EPS = 1e-12
_RIDGE = 1e-8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "newton_solver.cu")
WIDE_SOURCE = os.path.join(_PKG, "csrc", "newton_solver_wide.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no multiply-add contraction, so the plain version (which
# has none) rounds as the kernel does; see `newton_solve_reference`.
# chip_smoke.py holds the two to 1e-4 on the myoHand, whose Newton objective
# is flat to float32 resolution over whole rad/s^2 of qacc: a change to
# these flags, or to the order of any sum in the kernel, must be made in
# the plain version too, or that check moved to the gap between the two
# versions' objectives.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# launches of the warp and of the wide kernel since import (or since a
# caller reset them)
launches = 0
launches_wide = 0

_lib = None
_wide_lib = None


def _nvcc() -> str:
  path = shutil.which("nvcc")
  if path is None:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found: the CUDA kernel builds only where "
                       "the CUDA toolkit is installed")
  return path


def build(force: bool = False, defines: Tuple[str, ...] = (),
          source: str = SOURCE) -> Tuple[str, float, str]:
  """Compile a kernel's `source` (default the warp kernel) if needed;
  returns (library path, build seconds, the compiler's output: ptxas
  register and shared-memory report). `defines` are preprocessor macros,
  e.g. ("NEWTON_PHASE_CLOCKS",) for the warp kernel's phase-clock build,
  which goes to a library of its own."""
  with open(source, "rb") as f:
    src = f.read()
  flags = NVCC_FLAGS + tuple("-D" + d for d in defines)
  key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
  stem = os.path.splitext(os.path.basename(source))[0]
  lib = os.path.join(BUILD_DIR, f"{stem}_{key}.so")
  if os.path.exists(lib) and not force:
    return lib, 0.0, ""
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  t0 = time.perf_counter()
  proc = subprocess.run([_nvcc(), *flags, "-o", tmp, source],
                        capture_output=True, text=True)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
  os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
  return lib, seconds, proc.stdout + proc.stderr


def load(path: str):
  """The built warp-kernel library at `path`, its C interface declared for
  ctypes."""
  lib = ctypes.CDLL(path)
  ptr = ctypes.c_void_p
  i32 = ctypes.c_int
  lib.newton_solve_f32.argtypes = [ptr] * 14 + [i32] * 7 + [ptr, ptr]
  lib.newton_solve_f32.restype = i32
  lib.newton_solve_smem_per_env.argtypes = [i32, i32]
  lib.newton_solve_smem_per_env.restype = i32
  lib.newton_solve_occupancy.argtypes = [i32, i32, i32]
  lib.newton_solve_occupancy.restype = i32
  return lib


def load_wide(path: str):
  """The built wide-kernel library at `path`, its C interface declared for
  ctypes."""
  lib = ctypes.CDLL(path)
  ptr = ctypes.c_void_p
  i32, i64 = ctypes.c_int, ctypes.c_long
  lib.newton_wide_f32.argtypes = [ptr] * 16 + [i32] * 6 + [ptr]
  lib.newton_wide_f32.restype = i32
  for fn in (lib.newton_wide_workspace_floats, lib.newton_wide_smem_bytes):
    fn.argtypes = [i32, i32]
    fn.restype = i64
  lib.newton_wide_occupancy.argtypes = [i32, i32]
  lib.newton_wide_occupancy.restype = i32
  lib.newton_wide_config.argtypes = [i32, i32, ctypes.POINTER(i32)]
  lib.newton_wide_config.restype = i32
  return lib


def _library():
  global _lib
  if _lib is None:
    _lib = load(build()[0])
  return _lib


def _wide_library():
  global _wide_lib
  if _wide_lib is None:
    _wide_lib = load_wide(build(source=WIDE_SOURCE)[0])
  return _wide_lib


def _tri(n: int) -> int:
  return n * (n + 1) // 2


def warp_smem_per_env(nv: int, nefc: int) -> int:
  """Bytes of shared memory one env needs in the warp kernel: the C
  library's `newton_solve_smem_per_env`, computed here so that `route`
  needs no build (qM and J rows of stride 4 x odd, a staging row, the
  factor and eight row vectors, rounded up to 4 floats)."""
  ld = 4 * (((nv + 3) // 4) | 1)
  n = (nv + nefc + 1) * ld + _tri(nv) + 8 * nefc
  return 4 * ((n + 3) & ~3)


def wide_smem_bytes(nv: int, nefc: int) -> int:
  """Bytes of one env's working set in the wide kernel's shared memory (4
  scalars, qM rows of odd stride, the triangle, 7 dof and 7 row vectors,
  and the factor's pair buffer of 2 nv floats and 5 scalars, 8-byte
  aligned: inside the row vector of J p, which is dead in a factorization,
  where that holds it, else after the rows; J, aref, R, floss, active,
  qfrc_smooth and the damping are read from device memory): the C
  library's layout (`newton_wide_smem_bytes`), computed here for the CPU
  tests; the card's tests hold the two equal. Where it passes a block's
  limit, the kernel works in a device-memory workspace instead
  (`newton_wide_workspace_floats`)."""
  pair = 0 if nefc >= 2 * nv + 7 else 2 * nv + 6
  return 4 * (4 + nv * (nv | 1) + _tri(nv) + 7 * nv + 7 * nefc + pair)


def route(nv: int, nefc: int) -> str:
  """Which kernel solves a system of this shape: "warp" (newton_solver.cu)
  where nv <= 40 and one env fits in its shared memory, "wide"
  (newton_solver_wide.cu) for every other shape."""
  if nv <= MAX_NV and warp_smem_per_env(nv, nefc) <= _SMEM_LIMIT:
    return "warp"
  return "wide"


def flops_per_env(nv: int, nefc: int, iterations: int, ls_iterations: int,
                  n_weighted: float) -> float:
  """FP32 operations one env needs per launch, counted from the algorithm:
  a multiply-add is 2; Cholesky nv^3/3, a solve 2 nv^2, a mat-vec 2 nv^2,
  J x 2 nefc nv, a cost evaluation a mat-vec, J x and ~6 per row. A row
  of weight 0 adds nothing to J^T W J or to J^T f, so those count only
  the `n_weighted` rows the data weights (`weighted_rows`). The Hessian
  is symmetric, so J^T W J counts its lower triangle, n_weighted nv
  (nv + 1). The warm start evaluates two costs; each iteration one, at the
  new point, since the current point's cost, J a - aref and
  qM (a - a_smooth) are known from the test that accepted it."""
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
  """Mean rows per env that J^T W J and J^T f need at the solution (force
  as `newton_solve` returns it): every friction row, and each limit row
  that pushes. The warm-started iterations stay near the solution, so
  this stands for their count."""
  return n_friction + float((force[:, n_friction:] != 0).sum(1).double()
                            .mean())


def bytes_per_env(nv: int, nefc: int) -> int:
  """Device bytes one env must move: each input read and output written
  once (qM, J, 4 row vectors, 3 dof vectors in; 4 dof vectors and the row
  forces out)."""
  return 4 * (nv * nv + nefc * nv + 4 * nefc + 3 * nv + 4 * nv + nefc)


def random_system(rng, nv: int, nefc: int, n_friction: int):
  """One random well-posed system, as numpy float32 arrays in the order of
  `newton_solve`'s arguments without the batch axis: a PD mass matrix,
  `n_friction` friction rows, then limit rows about 70% active. For
  holding the kernel against its plain version."""
  A = rng.standard_normal((nv, nv)).astype(np.float32)
  qM = A @ A.T + 2.0 * np.eye(nv, dtype=np.float32)
  J = rng.standard_normal((nefc, nv)).astype(np.float32)
  aref = rng.standard_normal(nefc).astype(np.float32)
  R = (0.1 + rng.random(nefc)).astype(np.float32)
  floss = np.zeros(nefc, dtype=np.float32)
  floss[:n_friction] = 0.5 + rng.random(n_friction)
  active = np.ones(nefc, dtype=np.float32)
  active[n_friction:] = (rng.random(nefc - n_friction) > 0.3)
  warm = rng.standard_normal(nv).astype(np.float32)
  qfrc_smooth = rng.standard_normal(nv).astype(np.float32)
  damph = (0.01 * rng.random(nv)).astype(np.float32)
  return qM, J, aref, R, floss, active, warm, qfrc_smooth, damph


# Synthetic systems that hold the kernel against its plain version at its
# edges, as (nv, nefc, n_friction, limits, batch, non_pd): every lane of
# the tile (nv 32), more rows than a warp (nefc 70), friction rows or
# none, every limit row active or none, batches that are not a multiple of
# the envs per block, a mass matrix with a negative pivot, the pose
# models' shapes: the elbow (nv 1, one limit row) and the finger (nv 4,
# four limit rows), where most of the tile is padding, and the myoLeg's
# (nv 20, 14 joint-limit and 40 contact rows, no friction rows). Past 32
# dofs each lane holds a second element of every vector and the tile has a
# fifth row block (TI 5): nv 33, 35, 38 and 40, one with friction rows and
# one with a negative pivot at nv 35; then the in-hand manipulation
# models' (nv, nefc) with contact rows and no friction rows: KeyTurn
# (24, 168), ObjHold (29, 83), DieReorient (29, 151), Baoding (35, 147).
EDGE_CASES = ((5, 9, 3, "some", 5, False), (5, 9, 3, "some", 37, False),
              (5, 70, 3, "some", 37, False), (23, 23, 0, "all", 37, False),
              (23, 23, 0, "none", 37, False), (23, 70, 3, "some", 37, False),
              (32, 9, 0, "some", 37, False), (32, 23, 3, "some", 37, False),
              (32, 70, 3, "all", 37, False), (23, 9, 3, "some", 37, True),
              (1, 1, 0, "all", 37, False), (1, 1, 0, "none", 37, False),
              (4, 4, 0, "some", 37, False), (20, 54, 0, "some", 37, False),
              (33, 9, 0, "some", 37, False), (35, 40, 0, "some", 37, False),
              (38, 70, 0, "some", 37, False), (40, 23, 0, "all", 37, False),
              (35, 40, 3, "some", 37, False), (35, 23, 0, "some", 37, True),
              (24, 168, 0, "some", 37, False), (29, 83, 0, "some", 37, False),
              (29, 151, 0, "some", 37, False),
              (35, 147, 0, "some", 37, False),
              # the MyoChallenge shapes: Soccer, TableTennis, Relocate and
              # Bimanual (2 envs per block)
              (26, 138, 0, "some", 37, False), (33, 39, 0, "some", 37, False),
              (33, 235, 0, "some", 37, False),
              (38, 336, 0, "some", 37, False))

# The wide route's edges, in the same form: past one warp's two dofs per
# lane (nv 41, 45, 64, 96, 256), one row and the cluttered Relocate scene's
# 375 at nv 45, 1,200 rows at nv 38 (past the warp kernel's shared
# memory), friction rows, every limit row active or none, a mass matrix
# with a negative pivot, batches that are not a multiple of anything; and
# two where the wide kernel works in its device-memory workspace: nv 200
# with friction rows and nv 256, where qM alone passes a block's shared
# memory. Bimanual's (38, 336) takes the warp kernel; the wide kernel is
# held there in chip_smoke.py phase 16c. Then the edges of the Cholesky by
# entries, which takes columns in pairs: nv 47 and 48, whose first pair's
# trailing triangles (1,035 and 1,081 entries, not a multiple of 128) pass
# the kernel's table of 1,024 entry places, and nv 41 at 110 rows, every
# limit row active.
WIDE_EDGE_CASES = ((41, 9, 0, "some", 37, False),
                   (41, 70, 3, "some", 37, False),
                   (45, 1, 0, "all", 37, False),
                   (45, 375, 0, "some", 37, False),
                   (45, 60, 3, "all", 37, False),
                   (45, 40, 0, "none", 37, False),
                   (45, 23, 0, "some", 37, True),
                   (64, 90, 3, "some", 37, False),
                   (96, 150, 0, "some", 5, False),
                   (38, 1200, 0, "some", 5, False),
                   (38, 1200, 3, "some", 5, True),
                   (200, 100, 3, "some", 3, False),
                   (256, 300, 0, "some", 3, False),
                   (47, 33, 0, "some", 37, False),
                   (48, 100, 3, "some", 37, False),
                   (41, 110, 0, "all", 37, False))

# The wide kernel's factor takes columns in pairs and finishes in warp 0
# once at most 15 rows lie below a pair: at nv 17 the whole factor runs
# there (an odd last column too), at nv 18 and 19 one pair runs first under
# block barriers (then 14 and 15 rows). These shapes take the warp route,
# so the card holds the wide kernel there by calling it directly.
WIDE_FINISH_CASES = ((17, 20, 0, "some", 37, False),
                     (18, 20, 3, "some", 37, False),
                     (19, 9, 0, "all", 37, False))


def random_batch(seed: int, nv: int, nefc: int, n_friction: int,
                 limits: str, batch: int, non_pd: bool):
  """`batch` systems of `random_system`, stacked as CPU tensors in the
  order of `newton_solve`'s arguments (one row of EDGE_CASES after the
  seed). `limits`: "some" keeps random_system's ~70% active limit rows,
  "all" or "none" sets them all; `non_pd` gives env 0 a diagonal mass
  matrix with a negative pivot."""
  rng = np.random.default_rng(seed)
  args = [np.stack(x) for x in zip(*[random_system(rng, nv, nefc, n_friction)
                                     for _ in range(batch)])]
  if limits != "some":
    args[5][:, n_friction:] = 1.0 if limits == "all" else 0.0
  if non_pd:
    args[0][0] = np.diag(np.linspace(1.0, 3.0, nv)).astype(np.float32)
    args[0][0, nv // 2, nv // 2] = -2.0
  return [torch.from_numpy(a) for a in args]


def _check(qM, J, aref, R, floss, active, warm, qfrc_smooth, damph):
  if qM.dim() != 3 or qM.shape[1] != qM.shape[2]:
    raise ValueError(f"qM must be (B, nv, nv), got {tuple(qM.shape)}")
  B, nv = qM.shape[0], qM.shape[1]
  if J.dim() != 3:
    raise ValueError(f"J must be (B, nefc, nv), got {tuple(J.shape)}")
  nefc = J.shape[1]
  want = {"J": (B, nefc, nv), "aref": (B, nefc), "R": (B, nefc),
          "floss": (B, nefc), "active": (B, nefc), "warm": (B, nv),
          "qfrc_smooth": (B, nv), "damph": (B, nv)}
  got = dict(J=J, aref=aref, R=R, floss=floss, active=active, warm=warm,
             qfrc_smooth=qfrc_smooth, damph=damph)
  for name, shape in want.items():
    if tuple(got[name].shape) != shape:
      raise ValueError(f"{name} must be {shape}, got "
                       f"{tuple(got[name].shape)}")
  return B, nv, nefc


def newton_solve(qM, J, aref, R, floss, active, warm, qfrc_smooth, damph,
                 n_friction: int, iterations: int, ls_iterations: int):
  """Fused smooth + Newton + implicit-Euler solve of a batch of systems.

  Args lead with the env axis: qM (B,nv,nv), J (B,nefc,nv), aref, R,
  floss, active (B,nefc) (active as float 0/1), warm, qfrc_smooth, damph
  (B,nv). Rows [0, n_friction) are friction rows. Returns (qacc,
  qfrc_constraint, efc_force, qacc_smooth, qacc_euler). CUDA tensors go
  to the kernel of `route(nv, nefc)`, CPU tensors to its plain version.
  """
  global launches, launches_wide
  args = (qM, J, aref, R, floss, active, warm, qfrc_smooth, damph)
  kw = dict(n_friction=n_friction, iterations=iterations,
            ls_iterations=ls_iterations)
  _, nv, nefc = _check(*args)
  wide = route(nv, nefc) == "wide"
  if qM.device.type == "cpu":
    return (newton_solve_wide_reference if wide
            else newton_solve_reference)(*args, **kw)
  if wide:
    outs = _launch_wide(_wide_library(), args, **kw)
    launches_wide += 1
  else:
    outs = _launch(_library(), args, None, **kw)
    launches += 1
  return outs


def _envs_per_block(lib, nv: int, nefc: int) -> int:
  smem = lib.newton_solve_smem_per_env(nv, nefc)
  if smem > _SMEM_LIMIT:
    raise ValueError(f"nv={nv}, nefc={nefc} needs {smem} bytes of shared "
                     f"memory per env; a block may use {_SMEM_LIMIT}")
  return min(ENVS_PER_BLOCK, _SMEM_LIMIT // smem)


def _check_device(args):
  qM = args[0]
  if qM.device.type != "cuda":
    raise ValueError(f"no Newton solver for device {qM.device}")
  for a in args:
    if a.device != qM.device or a.dtype != torch.float32 or not \
        a.is_contiguous():
      raise ValueError("the Newton kernel takes contiguous float32 tensors "
                       f"on {qM.device}")


def _outputs(aref, warm):
  """(qacc, qfrc, force, asmooth, qacc_euler), uninitialised."""
  return (torch.empty_like(warm), torch.empty_like(warm),
          torch.empty_like(aref), torch.empty_like(warm),
          torch.empty_like(warm))


def _launch(lib, args, cycles, n_friction, iterations, ls_iterations):
  """One launch of `lib`'s kernel on CUDA tensors; `cycles` is None or the
  phase-clock buffer."""
  qM, J, aref, warm = args[0], args[1], args[2], args[6]
  B, nv, nefc = qM.shape[0], qM.shape[1], J.shape[1]
  _check_device(args)
  epb = _envs_per_block(lib, nv, nefc)
  outs = _outputs(aref, warm)
  qacc, qfrc, force, asmooth, qacc_euler = outs
  err = lib.newton_solve_f32(
      *[a.data_ptr() for a in args],
      qacc.data_ptr(), qfrc.data_ptr(), force.data_ptr(),
      asmooth.data_ptr(), qacc_euler.data_ptr(), B, nv, nefc,
      int(n_friction), int(iterations), int(ls_iterations), epb,
      None if cycles is None else cycles.data_ptr(),
      torch.cuda.current_stream(qM.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"newton_solve_f32 launch failed: CUDA error {err}")
  return outs


def _launch_wide(lib, args, n_friction, iterations, ls_iterations,
                 cycles=None):
  """One launch of the wide kernel in `lib` on CUDA tensors, with the
  per-env workspace in device memory where one env's working set does not
  fit in shared memory; `cycles` is None or the phase-clock buffer."""
  qM, J, aref, warm = args[0], args[1], args[2], args[6]
  B, nv, nefc = qM.shape[0], qM.shape[1], J.shape[1]
  _check_device(args)
  ws_floats = lib.newton_wide_workspace_floats(nv, nefc)
  work = (torch.empty(B * ws_floats, dtype=torch.float32, device=qM.device)
          if ws_floats else None)
  outs = _outputs(aref, warm)
  err = lib.newton_wide_f32(
      *[a.data_ptr() for a in args], *[o.data_ptr() for o in outs],
      None if work is None else work.data_ptr(),
      None if cycles is None else cycles.data_ptr(), B, nv, nefc,
      int(n_friction), int(iterations), int(ls_iterations),
      torch.cuda.current_stream(qM.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"newton_wide_f32 launch failed: CUDA error {err}")
  return outs


def wide_occupancy(nv: int, nefc: int, lib=None) -> Tuple[int, bool]:
  """(blocks per SM, whether one env's working set is in shared memory) of
  the wide kernel at these sizes, from
  cudaOccupancyMaxActiveBlocksPerMultiprocessor; a block is one env."""
  lib = lib or _wide_library()
  blocks = lib.newton_wide_occupancy(nv, nefc)
  if blocks <= 0:
    raise RuntimeError(f"newton_wide_occupancy failed: CUDA error "
                       f"{-blocks}")
  return blocks, lib.newton_wide_workspace_floats(nv, nefc) == 0


WIDE_CONFIG = ("carveout_pct", "registers", "local_bytes", "split_kb",
               "smem_blocks", "smem_blocks_largest")


def wide_config(nv: int, nefc: int, lib=None) -> Dict[str, int]:
  """What a launch of the wide kernel at these sizes is set up with, read
  back from the runtime (`newton_wide_config`): the shared-memory carveout
  it asks for (percent of the largest split; -1 none) and the split that
  selects (KB of shared memory; -1 the runtime's default), registers and
  local-memory bytes a thread of the instantiation launched, and the
  blocks per SM that shared memory alone allows at that split and at the
  largest."""
  lib = lib or _wide_library()
  out = (ctypes.c_int * len(WIDE_CONFIG))()
  err = lib.newton_wide_config(nv, nefc, out)
  if err != 0:
    raise RuntimeError(f"newton_wide_config failed: CUDA error {err}")
  return dict(zip(WIDE_CONFIG, out))


def occupancy(nv: int, nefc: int, lib=None) -> Tuple[int, int]:
  """(blocks per SM, envs per block) of the kernel at these sizes, from
  cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
  lib = lib or _library()
  epb = _envs_per_block(lib, nv, nefc)
  blocks = lib.newton_solve_occupancy(nv, nefc, epb)
  if blocks <= 0:
    raise RuntimeError(f"newton_solve_occupancy failed: CUDA error "
                       f"{-blocks}")
  return blocks, epb


# the phases of the NEWTON_PHASE_CLOCKS builds, in the order of their
# clocks
PHASES = ("staging", "smooth solve", "warm start", "forces + grad",
          "Hessian", "Cholesky", "solve", "line search", "accept costs",
          "final forces", "Euler solve")


def phase_cycles(*args, n_friction: int, iterations: int,
                 ls_iterations: int, lib=None) -> torch.Tensor:
  """Clock cycles per env and phase (B, len(PHASES)) of one launch of the
  phase-clock build of the inputs' route's kernel (`lib`, or built on
  first use; never the library `newton_solve` launches, and not counted
  in the launches). The warp kernel counts one warp's cycles, the wide
  kernel its block's."""
  _, nv, nefc = _check(*args)
  kw = dict(n_friction=n_friction, iterations=iterations,
            ls_iterations=ls_iterations)
  cycles = torch.zeros(args[0].shape[0], len(PHASES), dtype=torch.int64,
                       device=args[0].device)
  if route(nv, nefc) == "wide":
    lib = lib or load_wide(build(defines=("NEWTON_PHASE_CLOCKS",),
                                 source=WIDE_SOURCE)[0])
    _launch_wide(lib, args, cycles=cycles, **kw)
  else:
    lib = lib or load(build(defines=("NEWTON_PHASE_CLOCKS",))[0])
    _launch(lib, args, cycles, **kw)
  return cycles


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


#
# Every sum below is taken in the kernel's order, and the kernel is built
# without multiply-add contraction (`-fmad=false`), so the two round alike
# and agree to the last bit. That matters on the myoHand: its light finger
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


# The wide kernel's plain version. The wide kernel takes every sum in the
# warp kernel's order (dot products over k ascending, J^T W J and J^T f over
# rows ascending, the Cholesky's subtractions over k ascending, whole-vector
# sums in warp 0's lane order and butterfly), so one plain version is both
# kernels', and the two kernels agree bit for bit at a shape both take.
newton_solve_wide_reference = newton_solve_reference

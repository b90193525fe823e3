// Fused Newton constraint solver for batches of small systems, sm_90a.
//
// Replaces the Pallas TPU kernel `_solver_kernel` in
// myosuite_tpu/physics/pallas_solver.py. One launch per physics substep
// does, for every env of the batch:
//   1. a_smooth = qM^-1 qfrc_smooth (Cholesky, pivots clamped at 1e-12);
//   2. warm start: keep the previous qacc if its total cost is lower;
//   3. `iterations` Newton steps: row forces and curvature (friction rows
//      are the prefix [0, n_friction), clipped to +-floss; the other rows
//      are one-sided limits), grad = qM (a - a_smooth) - J^T f,
//      H = J^T diag(w) J + qM + 1e-8 I by Cholesky (its lower triangle
//      only), `ls_iterations` exact 1-D Newton steps on alpha clipped to
//      [0, 4], and the new point kept only if the total cost does not rise;
//   4. the final row forces and qfrc = J^T force;
//   5. qacc_euler = (qM + diag(h damping))^-1 (qfrc_smooth + qfrc).
// Non-PD rule of the Pallas kernel: every pivot s is clamped to 1e-12 under
// the square root and the factor's diagonal is s / sqrt(max(s, 1e-12)), so a
// negative pivot gives a finite result where linalg.chol_factor gives NaN.
//
// What bounds it on an H100: FP32 arithmetic. At nv = nefc = 23 an env
// needs ~1.7e5 flops per launch with every row weighted, ~1.3e5 with the
// ~12 that the hand weights on the main path (newton_kernel.flops_per_env;
// most in the iterations' J^T W J and Cholesky), against ~5.3 KB of device
// traffic: 25-32 flops per byte, above the card's ~20 flops per byte FP32
// ridge (67 TFLOP/s over 3.35 TB/s).
//
// The accept test evaluates the cost at the current point again, and each
// iteration recomputes that point's J a - aref and qM (a - a_smooth), where
// carrying them from the previous test would do. Carrying them was
// measured 5% slower on an H100 (PERF.md) and raised the register count
// from 56 to 96 or more. The likely cause: the two cost evaluations are
// independent chains of shuffles that run interleaved, so dropping one
// shortens no dependency chain.
//
// Design: one warp per env, a few envs per block. Lane r owns row r of qM,
// of the Hessian and of its in-place Cholesky factor (so nv <= 32), and
// element r of every nv-vector, held in a register. Constraint rows are
// looped in strides of 32 (nefc is unbounded). The env's matrices and row
// vectors sit in dynamic shared memory with an odd row stride, so lane r
// reading row r is bank-conflict free; vectors are broadcast with
// __shfl_sync and dot products reduced with __shfl_xor_sync, whose
// butterfly gives every lane the same sum, so the warp's branches on costs
// stay uniform. Inputs are batch-first, so one env's (nv, nv) block is
// contiguous and a warp's loads coalesce.
//
// Built with -fmad=false: the plain PyTorch version
// (newton_kernel.newton_solve_reference) takes every sum in this file's
// order and has no multiply-add, so the two agree to the last bit.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;
constexpr float kRidge = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Sys {
  const float* M;   // qM, nv rows of stride ld
  float* H;         // Hessian / factor workspace, same layout
  const float* J;   // nefc rows of stride ld
  const float* aref;
  const float* rinv;
  const float* floss;
  const float* active;
  float* jar;
  float* jp;
  float* frc;
  float* wt;
  int nv, ld, nefc, nfr;
};

// lane r < nv: sum_k A[r, k] x_k, x distributed one element per lane
__device__ float matvec(const float* A, int ld, int nv, float x, int lane) {
  float s = 0.f;
  for (int k = 0; k < nv; ++k) {
    float xk = __shfl_sync(kFull, x, k);
    if (lane < nv) s += A[lane * ld + k] * xk;
  }
  return s;
}

// y_e = J_e . x for all rows (uniform loop so every lane joins the shuffles)
__device__ void rows_dot(const Sys& s, float x, float* out, int lane) {
  for (int e0 = 0; e0 < s.nefc; e0 += 32) {
    int e = e0 + lane;
    float acc = 0.f;
    for (int k = 0; k < s.nv; ++k) {
      float xk = __shfl_sync(kFull, x, k);
      if (e < s.nefc) acc += s.J[e * s.ld + k] * xk;
    }
    if (e < s.nefc) out[e] = acc;
  }
  __syncwarp();
}

// lane r < nv: sum_e J[e, r] f_e
__device__ float rows_t(const Sys& s, const float* f, int lane) {
  float acc = 0.f;
  if (lane < s.nv)
    for (int e = 0; e < s.nefc; ++e) acc += s.J[e * s.ld + lane] * f[e];
  return acc;
}

__device__ __forceinline__ void row_force(const Sys& s, int e, float jar,
                                          float* force, float* w) {
  float ri = s.rinv[e];
  float quad_f = -jar * ri;
  if (e < s.nfr) {
    float fl = s.floss[e];
    *force = fminf(fmaxf(quad_f, -fl), fl);
    *w = fabsf(quad_f) < fl ? ri : 0.f;
  } else {
    float on = (s.active[e] != 0.f && jar < 0.f) ? 1.f : 0.f;
    *force = on * quad_f;
    *w = on * ri;
  }
}

__device__ __forceinline__ float row_cost(const Sys& s, int e, float jar) {
  float ri = s.rinv[e];
  float quad = 0.5f * jar * jar * ri;
  if (e < s.nfr) {
    float fl = s.floss[e];
    float band = fl / fmaxf(ri, kEps);
    return fabsf(jar) < band ? quad : fl * fabsf(jar) - 0.5f * fl * band;
  }
  return (s.active[e] != 0.f && jar < 0.f) ? quad : 0.f;
}

// 0.5 (a - as)^T qM (a - as) + sum_e cost_e(J_e a - aref_e); same on all lanes
__device__ float total_cost(const Sys& s, float a, float as, int lane) {
  float da = a - as;
  float mda = matvec(s.M, s.ld, s.nv, da, lane);
  float quad = warp_sum(lane < s.nv ? da * mda : 0.f);
  float c = 0.f;
  for (int e0 = 0; e0 < s.nefc; e0 += 32) {
    int e = e0 + lane;
    float acc = 0.f;
    for (int k = 0; k < s.nv; ++k) {
      float ak = __shfl_sync(kFull, a, k);
      if (e < s.nefc) acc += s.J[e * s.ld + k] * ak;
    }
    if (e < s.nefc) c += row_cost(s, e, acc - s.aref[e]);
  }
  return 0.5f * quad + warp_sum(c);
}

// In-place left-looking Cholesky of the lower triangle of A; lane i owns
// row i. Column j: s_i = A[i][j] - sum_{k<j} L[i][k] L[j][k] for i >= j,
// then L[i][j] = s_i / sqrt(max(s_j, eps)).
__device__ void chol(float* A, int ld, int nv, int lane) {
  for (int j = 0; j < nv; ++j) {
    float s = 0.f;
    if (lane >= j && lane < nv) {
      s = A[lane * ld + j];
      for (int k = 0; k < j; ++k) s -= A[lane * ld + k] * A[j * ld + k];
    }
    float d = sqrtf(fmaxf(__shfl_sync(kFull, s, j), kEps));
    if (lane >= j && lane < nv) A[lane * ld + j] = s / d;
    __syncwarp();
  }
}

// Solve (L L^T) x = b; b and x one element per lane.
__device__ float chol_solve(const float* L, int ld, int nv, float b,
                            int lane) {
  float s = b;
  for (int i = 0; i < nv; ++i) {           // L y = b
    float yi = __shfl_sync(kFull, s, i) / L[i * ld + i];
    if (lane == i) s = yi;
    else if (lane > i && lane < nv) s -= L[lane * ld + i] * yi;
  }
  for (int i = nv - 1; i >= 0; --i) {      // L^T x = y
    float xi = __shfl_sync(kFull, s, i) / L[i * ld + i];
    if (lane == i) s = xi;
    else if (lane < i) s -= L[i * ld + lane] * xi;
  }
  return lane < nv ? s : 0.f;
}

__host__ __device__ inline int row_stride(int nv) { return nv | 1; }

__host__ __device__ inline int floats_per_env(int nv, int nefc) {
  return 2 * nv * row_stride(nv) + nefc * row_stride(nv) + 8 * nefc;
}

__global__ void newton_solve_kernel(
    const float* __restrict__ qM, const float* __restrict__ J,
    const float* __restrict__ aref, const float* __restrict__ R,
    const float* __restrict__ floss, const float* __restrict__ active,
    const float* __restrict__ warm, const float* __restrict__ qfs,
    const float* __restrict__ damph, float* __restrict__ qacc,
    float* __restrict__ qfrc, float* __restrict__ force,
    float* __restrict__ asmooth, float* __restrict__ qacc_euler, int batch,
    int nv, int nefc, int nfr, int iterations, int ls_iterations) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long env = (long)blockIdx.x * warps + warp;
  if (env >= batch) return;  // whole warp leaves; no block-wide barriers

  const int ld = row_stride(nv);
  float* base = smem + (long)warp * floats_per_env(nv, nefc);
  float* M = base;
  float* H = M + nv * ld;
  float* Jm = H + nv * ld;
  float* rv = Jm + nefc * ld;
  Sys s{M, H, Jm, rv, rv + nefc, rv + 2 * nefc, rv + 3 * nefc,
        rv + 4 * nefc, rv + 5 * nefc, rv + 6 * nefc, rv + 7 * nefc,
        nv, ld, nefc, nfr};

  const float* gM = qM + env * nv * nv;
  for (int i = lane; i < nv * nv; i += 32) M[(i / nv) * ld + i % nv] = gM[i];
  const float* gJ = J + env * nefc * nv;
  for (int i = lane; i < nefc * nv; i += 32)
    Jm[(i / nv) * ld + i % nv] = gJ[i];
  const long r0 = env * nefc;
  for (int e = lane; e < nefc; e += 32) {
    rv[e] = aref[r0 + e];
    rv[nefc + e] = 1.f / R[r0 + e];
    rv[2 * nefc + e] = floss[r0 + e];
    rv[3 * nefc + e] = active[r0 + e];
  }
  const long v0 = env * nv;
  const float qfs_r = lane < nv ? qfs[v0 + lane] : 0.f;
  const float warm_r = lane < nv ? warm[v0 + lane] : 0.f;
  const float damph_r = lane < nv ? damph[v0 + lane] : 0.f;
  __syncwarp();

  // 1. a_smooth
  for (int i = lane; i < nv * ld; i += 32) H[i] = M[i];
  __syncwarp();
  chol(H, ld, nv, lane);
  const float as = chol_solve(H, ld, nv, qfs_r, lane);

  // 2. warm start
  float a = total_cost(s, warm_r, as, lane) < total_cost(s, as, as, lane)
                ? warm_r : as;

  // 3. Newton iterations
  for (int it = 0; it < iterations; ++it) {
    rows_dot(s, a, s.jar, lane);
    for (int e = lane; e < nefc; e += 32) {
      s.jar[e] -= s.aref[e];
      row_force(s, e, s.jar[e], &s.frc[e], &s.wt[e]);
    }
    __syncwarp();
    const float mda = matvec(M, ld, nv, a - as, lane);
    const float grad = mda - rows_t(s, s.frc, lane);
    if (lane < nv) {   // lower triangle: chol reads no other entry
      for (int c = 0; c <= lane; ++c) {
        float h = 0.f;
        for (int e = 0; e < nefc; ++e)
          h += Jm[e * ld + lane] * s.wt[e] * Jm[e * ld + c];
        h += M[lane * ld + c];
        if (c == lane) h += kRidge;
        H[lane * ld + c] = h;
      }
    }
    __syncwarp();
    chol(H, ld, nv, lane);
    const float p = -chol_solve(H, ld, nv, grad, lane);

    rows_dot(s, p, s.jp, lane);
    const float g0 = warp_sum(lane < nv ? p * mda : 0.f);
    const float mp = matvec(M, ld, nv, p, lane);
    const float pmp = warp_sum(lane < nv ? p * mp : 0.f);
    float alpha = 1.f;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float sf = 0.f, sw = 0.f;
      for (int e = lane; e < nefc; e += 32) {
        float f, w;
        const float jpe = s.jp[e];
        row_force(s, e, s.jar[e] + alpha * jpe, &f, &w);
        sf += f * jpe;
        sw += w * jpe * jpe;
      }
      const float dphi = g0 + alpha * pmp - warp_sum(sf);
      const float ddphi = pmp + warp_sum(sw);
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, kEps), 0.f), 4.f);
    }
    const float a_new = a + alpha * p;
    if (total_cost(s, a_new, as, lane) <= total_cost(s, a, as, lane))
      a = a_new;
  }

  // 4. final forces and qfrc
  rows_dot(s, a, s.jar, lane);
  for (int e = lane; e < nefc; e += 32) {
    float f, w;
    row_force(s, e, s.jar[e] - s.aref[e], &f, &w);
    s.frc[e] = f;
    force[r0 + e] = f;
  }
  __syncwarp();
  const float qfrc_r = rows_t(s, s.frc, lane);

  // 5. implicit-damping Euler solve
  for (int i = lane; i < nv * ld; i += 32) H[i] = M[i];
  __syncwarp();
  if (lane < nv) H[lane * ld + lane] += damph_r;
  __syncwarp();
  chol(H, ld, nv, lane);
  const float qe = chol_solve(H, ld, nv, qfs_r + qfrc_r, lane);

  if (lane < nv) {
    qacc[v0 + lane] = a;
    qfrc[v0 + lane] = qfrc_r;
    asmooth[v0 + lane] = as;
    qacc_euler[v0 + lane] = qe;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one env needs.
int newton_solve_smem_per_env(int nv, int nefc) {
  return (int)sizeof(float) * floats_per_env(nv, nefc);
}

// All pointers are device pointers to contiguous float32, batch-first:
// qM (B,nv,nv), J (B,nefc,nv), aref/R/floss/active (B,nefc),
// warm/qfrc_smooth/damph (B,nv); outputs qacc, qfrc, asmooth, qacc_euler
// (B,nv) and force (B,nefc). Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int newton_solve_f32(const void* qM, const void* J, const void* aref,
                     const void* R, const void* floss, const void* active,
                     const void* warm, const void* qfrc_smooth,
                     const void* damph, void* qacc, void* qfrc, void* force,
                     void* asmooth, void* qacc_euler, int batch, int nv,
                     int nefc, int n_friction, int iterations,
                     int ls_iterations, int envs_per_block, void* stream) {
  if (batch <= 0) return 0;
  if (nv < 1 || nv > 32 || nefc < 0 || envs_per_block < 1 ||
      envs_per_block > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)envs_per_block * newton_solve_smem_per_env(nv, nefc);
  cudaError_t err = cudaFuncSetAttribute(
      newton_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + envs_per_block - 1) / envs_per_block;
  newton_solve_kernel<<<blocks, 32 * envs_per_block, smem,
                        (cudaStream_t)stream>>>(
      (const float*)qM, (const float*)J, (const float*)aref,
      (const float*)R, (const float*)floss, (const float*)active,
      (const float*)warm, (const float*)qfrc_smooth, (const float*)damph,
      (float*)qacc, (float*)qfrc, (float*)force, (float*)asmooth,
      (float*)qacc_euler, batch, nv, nefc, n_friction, iterations,
      ls_iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"

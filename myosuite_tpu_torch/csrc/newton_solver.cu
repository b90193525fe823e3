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
// What bounds it on an H100. The function is FP32 arithmetic: at
// nv = nefc = 23 ~1.3e5 operations per env against ~5.3 KB of device
// traffic (newton_kernel.flops_per_env, bytes_per_env), above the card's
// ~20 flops per byte FP32 ridge. The kernel runs far from that bound. One
// warp per env walks long chains of dependent steps: every Cholesky step
// waits for a shuffle, a correctly rounded square root, a division and a
// round of broadcasts before the next pivot, every line-search step for
// two warp sums and a division. With one block per SM (a quarter of the
// warps) a launch takes more than half as long as with four, so those
// chains, not instruction issue, set most of its time; four blocks of
// 8 warps (64 registers at most) make batch 4096 one wave.
//
// Design: one warp per env, a few envs per block. Lane r owns elements r
// and, past nv 32, r + 32 of every nv-vector, held in registers (a `Vec`
// of one or two halves, so nv <= 40); a dot product adds the lane's
// products, half 0 then half 1, and reduces with __shfl_xor_sync, whose
// butterfly gives every lane the same sum, so the warp's branches on costs
// stay uniform. Inputs are
// batch-first, so one env's (nv, nv) block is contiguous and a warp's
// loads coalesce. What the design does to shorten and thin the chains:
// - J x, qM x and the cost sums give each lane a row and read it 16 bytes
//   at a time against the vector staged once in shared memory (rows of
//   stride 4 x odd: no bank conflicts), not one shuffle per column.
// - J^T W J and the Cholesky run on a register tile that keeps all 32
//   lanes busy: lane (lr, lc) = (lane % 8, lane / 8) owns the entries
//   (lr + 8 ii, lc + 4 jj), ii < TI, jj < 2 TI, of the matrix padded to
//   8 TI rows (TI = ceil(nv / 8), a template parameter, so the tile is
//   registers). J^T W J sums only the rows of nonzero weight, found 32 at a
//   time with __ballot_sync: per row a lane loads 3 TI values of J and
//   updates its tile, where one row per lane loaded three values per entry.
//   J^T f likewise skips rows of zero force. A skipped row adds +-0 to a sum
//   that starts at +0, which changes no bit of a finite sum.
// - The Cholesky is right-looking on the tile: at step k the pivot and
//   column k are broadcast by shuffles whose register indices are known at
//   compile time, each lane divides once, and every lane updates its part
//   of the trailing triangle; the forward substitution rides along. The
//   factor goes to shared memory, packed by rows, for the backward sweep.
// - Each iteration starts from the cost, qM (a - a_smooth) and J a - aref
//   that the accept test computed for the point it took (two row buffers,
//   swapped by index), so a Newton step evaluates one cost, not two, and
//   no separate J a or qM a.
//
// Every sum keeps the order of the plain PyTorch version
// (newton_kernel.newton_solve_reference): dot products over k ascending,
// J^T W J and J^T f over rows ascending, the Cholesky's subtractions over
// k ascending, the cost sums over every row in the warp's butterfly order.
// Built with -fmad=false, so the two agree to the last bit.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;
constexpr float kRidge = 1e-8f;

// Phases of the solve timed by the NEWTON_PHASE_CLOCKS build (names in
// newton_kernel.PHASES): lane 0 of each warp adds the clock64() cycles of
// each phase to a counter in the env's shared memory (a global
// read-modify-write would stall the warp on a device-memory load at every
// stamp), and the counters go to cycles[env * kPhases + phase] at the end.
// Off in the build the main path loads.
constexpr int kPhases = 11;
enum Phase { kStaging, kSmooth, kWarm, kForces, kHessian, kChol, kSolve,
             kLineSearch, kAccept, kFinal, kEuler };
#ifdef NEWTON_PHASE_CLOCKS
constexpr int kPhaseFloats = kPhases;   // one 32-bit counter per phase
#define PHASE(ph) phase_stamp(phase_acc, lane, &t_phase, ph)
__device__ __forceinline__ void phase_stamp(unsigned* acc, int lane,
                                            long long* t, int ph) {
  __syncwarp();
  const long long now = clock64();
  if (lane == 0) acc[ph] += (unsigned)(now - *t);
  *t = now;
}
#else
constexpr int kPhaseFloats = 0;
#define PHASE(ph) ((void)0)
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A lane's share of an nv-vector: h[i] is element lane + 32 i. One half up
// to nv 32, two up to nv 40 (the tile's TI 5).
template <int NH>
struct Vec {
  float h[NH];
};
__host__ __device__ constexpr int halves(int ti) { return ti > 4 ? 2 : 1; }

// g[lane + 32 i], 0 past nv
template <int NH>
__device__ __forceinline__ Vec<NH> load_vec(const float* g, int nv,
                                            int lane) {
  Vec<NH> v;
#pragma unroll
  for (int i = 0; i < NH; ++i)
    v.h[i] = lane + 32 * i < nv ? g[lane + 32 * i] : 0.f;
  return v;
}

template <int NH>
__device__ __forceinline__ void store_vec(float* g, const Vec<NH>& v, int nv,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < NH; ++i)
    if (lane + 32 * i < nv) g[lane + 32 * i] = v.h[i];
}

// The lane's part of sum_k a_k b_k before the butterfly: its element of
// half 0, plus that of half 1 where it lies below nv
template <int NH>
__device__ __forceinline__ float lane_dot(const Vec<NH>& a, const Vec<NH>& b,
                                          int nv, int lane) {
  float acc = lane < nv ? a.h[0] * b.h[0] : 0.f;
#pragma unroll
  for (int i = 1; i < NH; ++i)
    if (lane + 32 * i < nv) acc = acc + a.h[i] * b.h[i];
  return acc;
}

// One env's shared memory, in floats: qM (nv rows) and J (nefc rows) of
// stride ld, a multiple of 4 whose quotient is odd, so that a lane reading
// its own row 16 bytes at a time meets no bank conflict (columns nv..ld are
// 0); the staging slot xs (ld) of the vector those rows are multiplied by;
// the Cholesky factor packed by rows (row r at r (r + 1) / 2); then eight
// row vectors (J a - aref twice: the current point's and the candidate's).
// Regions are offsets from one base, so the compiler keeps no pointer per
// region.
__host__ __device__ inline int row_stride(int nv) {
  return 4 * (((nv + 3) / 4) | 1);
}
__host__ __device__ inline int tri(int r) { return r * (r + 1) / 2; }

__host__ __device__ inline int floats_per_env(int nv, int nefc) {
  const int n = (nv + nefc + 1) * row_stride(nv) + tri(nv) + 8 * nefc +
                kPhaseFloats;
  return (n + 3) & ~3;   // keeps every env's base 16-byte aligned
}

struct Sys {
  float* base;
  int nv, ld, nefc, nfr;
  __device__ __forceinline__ int nq() const { return (nv + 3) / 4; }
  __device__ __forceinline__ float* M() const { return base; }
  __device__ __forceinline__ float* J() const { return base + nv * ld; }
  __device__ __forceinline__ float* xs() const {
    return base + (nv + nefc) * ld;
  }
  __device__ __forceinline__ float* H() const {
    return base + (nv + nefc + 1) * ld;
  }
  __device__ __forceinline__ float* rows(int i) const {
    return H() + tri(nv) + i * nefc;
  }
  __device__ __forceinline__ float* aref() const { return rows(0); }
  __device__ __forceinline__ float* rinv() const { return rows(1); }
  __device__ __forceinline__ float* floss() const { return rows(2); }
  __device__ __forceinline__ float* active() const { return rows(3); }
  __device__ __forceinline__ float* jar(int i) const { return rows(4 + i); }
  __device__ __forceinline__ float* jp() const { return rows(6); }
  __device__ __forceinline__ float* wt() const { return rows(7); }
  __device__ __forceinline__ unsigned* phase_acc() const {
    return reinterpret_cast<unsigned*>(rows(8));
  }
};

// x into the staging slot, zero past nv
template <int NH>
__device__ __forceinline__ void stage(const Sys& s, const Vec<NH>& x,
                                      int lane) {
  __syncwarp();   // the last readers of the slot are done
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int r = lane + 32 * i;
    if (r < 4 * s.nq()) s.xs()[r] = r < s.nv ? x.h[i] : 0.f;
  }
  __syncwarp();
}

// sum_k row[k] xs[k] over k ascending, four at a time from 16-byte loads;
// the terms past nv are 0 * 0, and a sum that starts at +0 never becomes
// -0, so adding them changes no bit
__device__ __forceinline__ float row_dot(const Sys& s, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* x4 = reinterpret_cast<const float4*>(s.xs());
  float acc = 0.f;
  for (int q = 0; q < s.nq(); ++q) {
    const float4 a = r4[q], x = x4[q];
    acc = acc + a.x * x.x;
    acc = acc + a.y * x.y;
    acc = acc + a.z * x.z;
    acc = acc + a.w * x.w;
  }
  return acc;
}

// the lane's rows of the staged vector times qM: sum_k qM[r, k] xs_k for
// r = lane + 32 i < nv
template <int NH>
__device__ __forceinline__ Vec<NH> qM_rows(const Sys& s, int lane) {
  Vec<NH> y;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int r = lane + 32 * i;
    y.h[i] = r < s.nv ? row_dot(s, s.M() + r * s.ld) : 0.f;
  }
  return y;
}

// qM x
template <int NH>
__device__ __forceinline__ Vec<NH> matvec(const Sys& s, const Vec<NH>& x,
                                          int lane) {
  stage(s, x, lane);
  return qM_rows<NH>(s, lane);
}

// acc + sum_b J[e0 + b, r] f_b for r = lane + 32 i < nv, over the lanes b
// whose row force f is nonzero, in ascending rows
template <int NH>
__device__ __forceinline__ void add_rows_t(const Sys& s, int e0, float f,
                                           Vec<NH>& acc, int lane) {
  unsigned m = __ballot_sync(kFull, f != 0.f);
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const float fb = __shfl_sync(kFull, f, b);
    const float* Je = s.J() + (e0 + b) * s.ld;
#pragma unroll
    for (int i = 0; i < NH; ++i)
      if (lane + 32 * i < s.nv) acc.h[i] += Je[lane + 32 * i] * fb;
  }
}

__device__ __forceinline__ void row_force(const Sys& s, int e, float jar,
                                          float* force, float* w) {
  float ri = s.rinv()[e];
  float quad_f = -jar * ri;
  if (e < s.nfr) {
    float fl = s.floss()[e];
    *force = fminf(fmaxf(quad_f, -fl), fl);
    *w = fabsf(quad_f) < fl ? ri : 0.f;
  } else {
    float on = (s.active()[e] != 0.f && jar < 0.f) ? 1.f : 0.f;
    *force = on * quad_f;
    *w = on * ri;
  }
}

__device__ __forceinline__ float row_cost(const Sys& s, int e, float jar) {
  float ri = s.rinv()[e];
  float quad = 0.5f * jar * jar * ri;
  if (e < s.nfr) {
    float fl = s.floss()[e];
    float band = fl / fmaxf(ri, kEps);
    return fabsf(jar) < band ? quad : fl * fabsf(jar) - 0.5f * fl * band;
  }
  return (s.active()[e] != 0.f && jar < 0.f) ? quad : 0.f;
}

// 0.5 (a - as)^T qM (a - as) + sum_e cost_e(J_e a - aref_e), the same on
// all lanes; leaves qM (a - as) in mda (lane r) and J a - aref in jar, which
// the next iteration starts from if the point is taken. The two warp sums
// sit side by side so that their shuffle chains overlap.
template <int NH>
__device__ __forceinline__ float total_cost(const Sys& s, const Vec<NH>& a,
                                            const Vec<NH>& as, int lane,
                                            float* jar, Vec<NH>& mda) {
  Vec<NH> da;
#pragma unroll
  for (int i = 0; i < NH; ++i) da.h[i] = a.h[i] - as.h[i];
  mda = matvec(s, da, lane);
  const float qpart = lane_dot(da, mda, s.nv, lane);
  stage(s, a, lane);
  float c = 0.f;
  for (int e = lane; e < s.nefc; e += 32) {
    const float r = row_dot(s, s.J() + e * s.ld) - s.aref()[e];
    jar[e] = r;
    c += row_cost(s, e, r);
  }
  return 0.5f * warp_sum(qpart) + warp_sum(c);
}

// ---- the register tile: lane (lr, lc) owns (lr + 8 ii, lc + 4 jj) ----
// Entry blocks wholly above the diagonal (rows 8ii..8ii+7, columns
// 4jj..4jj+3) are never read or written.
__host__ __device__ constexpr bool lower(int ii, int jj) {
  return 8 * ii + 7 >= 4 * jj;
}

// A = S[r][c], rows and columns past nv clamped to nv - 1 (padding that
// no entry of the factor reads)
template <int TI>
__device__ __forceinline__ void tile_load(float (&A)[TI][2 * TI],
                                          const float* S, int ld, int nv,
                                          int lr, int lc) {
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    const float* row = S + min(lr + 8 * ii, nv - 1) * ld;
#pragma unroll
    for (int jj = 0; jj < 2 * TI; ++jj)
      if (lower(ii, jj)) A[ii][jj] = row[min(lc + 4 * jj, nv - 1)];
  }
}

// A = A + x_r on the diagonal and A + 0 elsewhere, as the plain version
// adds a diagonal matrix (so -0 becomes +0 off the diagonal, as there)
template <int TI>
__device__ __forceinline__ void tile_add_diag(float (&A)[TI][2 * TI],
                                              const float (&x)[TI], int lr,
                                              int lc) {
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
#pragma unroll
    for (int jj = 0; jj < 2 * TI; ++jj)
      if (lower(ii, jj))
        A[ii][jj] = A[ii][jj] + (lr + 8 * ii == lc + 4 * jj ? x[ii] : 0.f);
}

// In-place right-looking Cholesky of the tile's lower triangle. Step k:
// d = sqrt(max(S[k][k], eps)), L[i][k] = S[i][k] / d for i >= k, then
// S[i][j] -= L[i][k] L[j][k] for j > k, so each entry subtracts over k
// ascending. Column k lives in lanes lc = k % 4, at register column k / 4,
// its row i in lane i % 8 + 8 lc at register row i / 8: it is gathered to
// one row per lane and half (lane q holds rows q and q + 32, as a Vec), so
// each lane divides once per half, and broadcast back to the tile by row
// (lane lr + 8 (ii % 4), half ii / 4) and by column (lane (lc + 4 jj) % 32,
// half jj / 8). Register indices must be compile-time constants, so the
// loop over k / 4 is unrolled and the four steps inside it are not
// (unrolling all of them measured slower: more code, more spills). The
// forward substitution L y = b rides along: lane q holds b_q (and
// b_{q+32}), and at step k the lane of row k divides by L[k][k] and the
// rows below subtract L[q][k] y_k, the order of the plain version's column
// sweep.
template <int TI>
__device__ __forceinline__ void tile_chol(float (&A)[TI][2 * TI], int nv,
                                          int lr, int lc,
                                          Vec<halves(TI)>& b) {
  constexpr int TJ = 2 * TI;
  constexpr int NH = halves(TI);
  const int lane = lr + 8 * lc;
#pragma unroll
  for (int kj = 0; kj < TJ; ++kj) {
#pragma unroll 1
    for (int kc = 0; kc < 4 && 4 * kj + kc < nv; ++kc) {
      const int k = 4 * kj + kc;
      const float piv = __shfl_sync(kFull, A[kj >> 1][kj], (k & 7) + 8 * kc);
      const float d = sqrtf(fmaxf(piv, kEps));
      // S[q + 32 h][k], q = lane; rows above k are not needed
      float sq[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) sq[h] = 0.f;
#pragma unroll
      for (int ii = 0; ii < TI; ++ii)
        if (8 * ii + 7 >= 4 * kj) {
          const float v = __shfl_sync(kFull, A[ii][kj], lr + 8 * kc);
          if (lc == (ii & 3)) sq[ii >> 2] = v;
        }
      float lq[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) lq[h] = sq[h] / d;
      float li[TI], lj[TJ];
#pragma unroll
      for (int ii = 0; ii < TI; ++ii)
        if (8 * ii + 7 >= 4 * kj) {
          li[ii] = __shfl_sync(kFull, lq[ii >> 2], lr + 8 * (ii & 3));
          if (lc == kc) A[ii][kj] = li[ii];
        }
#pragma unroll
      for (int jj = kj; jj < TJ; ++jj)
        lj[jj] = __shfl_sync(kFull, lq[jj >> 3], lc + 4 * (jj & 7));
      // after the broadcasts, so that their latency overlaps the division of
      // row k's lane; k / 32 = kj / 8
      const int kh = kj >> 3;   // a constant once kj is unrolled
      if (lane == k - 32 * kh) b.h[kh] = b.h[kh] / lq[kh];
      const float yk = __shfl_sync(kFull, b.h[kh], k - 32 * kh);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        if (lane + 32 * h > k) b.h[h] = b.h[h] - lq[h] * yk;
#pragma unroll
      for (int ii = 0; ii < TI; ++ii)
#pragma unroll
        for (int jj = kj; jj < TJ; ++jj)
          if (lower(ii, jj)) {
            const float t = A[ii][jj] - li[ii] * lj[jj];
            if (jj > kj || lc > kc) A[ii][jj] = t;
          }
    }
  }
}

// The tile's lower triangle (rows < nv) into H, packed by rows
template <int TI>
__device__ __forceinline__ void tile_store(const float (&A)[TI][2 * TI],
                                           float* H, int nv, int lr, int lc) {
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
#pragma unroll
    for (int jj = 0; jj < 2 * TI; ++jj) {
      const int r = lr + 8 * ii, c = lc + 4 * jj;
      if (lower(ii, jj) && r < nv && c <= r) H[tri(r) + c] = A[ii][jj];
    }
}

// Solve L^T x = y with L packed by rows in H; y and x as Vecs. Rows
// 32..nv-1 (half 1) are taken first, so that the half a step divides in is
// known at compile time.
template <int NH>
__device__ __forceinline__ Vec<NH> chol_back(const float* L, int nv,
                                             Vec<NH> s, int lane) {
  float dg[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const int r = lane + 32 * h;
    dg[h] = r < nv ? L[tri(r) + r] : 1.f;
  }
#pragma unroll
  for (int h = NH - 1; h >= 0; --h) {
    for (int i = min(nv, 32 * (h + 1)) - 1; i >= 32 * h; --i) {
      if (lane == i - 32 * h) s.h[h] = s.h[h] / dg[h];
      const float xi = __shfl_sync(kFull, s.h[h], i - 32 * h);
#pragma unroll
      for (int g = 0; g <= h; ++g)
        if (lane + 32 * g < i) s.h[g] -= L[tri(i) + lane + 32 * g] * xi;
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h)
    if (lane + 32 * h >= nv) s.h[h] = 0.f;
  return s;
}

// Factor the tile, with the forward substitution of b (which becomes y),
// and leave the factor in H.
template <int TI>
__device__ __forceinline__ void tile_factor(float (&A)[TI][2 * TI], float* H,
                                            int nv, int lr, int lc,
                                            Vec<halves(TI)>& b) {
  tile_chol<TI>(A, nv, lr, lc, b);
  __syncwarp();   // the last solve has read H
  tile_store<TI>(A, H, nv, lr, lc);
  __syncwarp();
}

// A^-1 b for the tile A
template <int TI>
__device__ __forceinline__ Vec<halves(TI)> tile_solve(
    float (&A)[TI][2 * TI], float* H, int nv, int lr, int lc,
    Vec<halves(TI)> b) {
  tile_factor<TI>(A, H, nv, lr, lc, b);
  return chol_back(H, nv, b, lr + 8 * lc);
}

// TI = ceil(nv / 8) rows of tile per lane. At TI <= 3 (nv <= 24) the
// launch bounds cap registers at 64, so 4 blocks of 8 warps share an SM:
// batch 4096 is one wave on 132 SMs. TI 5 (nv 33..40) asks for one block
// per SM, so registers are capped at 255 and nothing spills; its shared
// memory allows one block per SM at any nefc anyway (two blocks of 8 envs
// would need nefc <= ~30).
template <int TI, int MIN_BLOCKS>
__global__ void __launch_bounds__(256, MIN_BLOCKS) newton_solve_kernel(
    const float* __restrict__ qM, const float* __restrict__ J,
    const float* __restrict__ aref, const float* __restrict__ R,
    const float* __restrict__ floss, const float* __restrict__ active,
    const float* __restrict__ warm, const float* __restrict__ qfs,
    const float* __restrict__ damph, float* __restrict__ qacc,
    float* __restrict__ qfrc, float* __restrict__ force,
    float* __restrict__ asmooth, float* __restrict__ qacc_euler,
    unsigned long long* __restrict__ cycles, int batch, int nv, int nefc,
    int nfr, int iterations, int ls_iterations) {
  constexpr int TJ = 2 * TI;
  constexpr int NH = halves(TI);
  extern __shared__ float4 smem4[];   // float4: 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, lc = lane >> 3;
  const long env = (long)blockIdx.x * warps + warp;
  if (env >= batch) return;  // whole warp leaves; no block-wide barriers
  const int ld = row_stride(nv);
  const Sys s{smem + warp * floats_per_env(nv, nefc), nv, ld, nefc, nfr};
#ifdef NEWTON_PHASE_CLOCKS
  unsigned* phase_acc = s.phase_acc();
  if (lane < kPhases) phase_acc[lane] = 0u;
  __syncwarp();
  long long t_phase = clock64();
#endif
  float* M = s.M();

  const float* gM = qM + env * nv * nv;
  for (int i = lane; i < nv * nv; i += 32) M[(i / nv) * ld + i % nv] = gM[i];
  const float* gJ = J + env * nefc * nv;
  for (int i = lane; i < nefc * nv; i += 32)
    s.J()[(i / nv) * ld + i % nv] = gJ[i];
  const int pad = 4 * s.nq() - nv;   // zero columns read by row_dot
  for (int i = lane; i < (nv + nefc) * pad; i += 32)
    M[(i / pad) * ld + nv + i % pad] = 0.f;
  const long r0 = env * nefc;
  for (int e = lane; e < nefc; e += 32) {
    s.aref()[e] = aref[r0 + e];
    s.rinv()[e] = 1.f / R[r0 + e];
    s.floss()[e] = floss[r0 + e];
    s.active()[e] = active[r0 + e];
  }
  const long v0 = env * nv;
  __syncwarp();
  PHASE(kStaging);

  float A[TI][TJ];

  // 1. a_smooth
  const Vec<NH> qfs_r = load_vec<NH>(qfs + v0, nv, lane);
  tile_load<TI>(A, M, ld, nv, lr, lc);
  const Vec<NH> as = tile_solve<TI>(A, s.H(), nv, lr, lc, qfs_r);
  PHASE(kSmooth);

  // 2. warm start. The current point a comes with its cost, qM (a - as)
  // and J a - aref (in buffer s.jar(cur)), from the test that took it.
  const Vec<NH> warm_r = load_vec<NH>(warm + v0, nv, lane);
  Vec<NH> mda, mda_s;
  float cost = total_cost(s, warm_r, as, lane, s.jar(0), mda);
  const float cost_s = total_cost(s, as, as, lane, s.jar(1), mda_s);
  Vec<NH> a = warm_r;
  int cur = 0;
  if (!(cost < cost_s)) {
    a = as;
    cost = cost_s;
    mda = mda_s;
    cur = 1;
  }
  PHASE(kWarm);

  // 3. Newton iterations
  for (int it = 0; it < iterations; ++it) {
    const float* jar = s.jar(cur);
    Vec<NH> grad = {};
    for (int e0 = 0; e0 < nefc; e0 += 32) {
      const int e = e0 + lane;
      float f = 0.f, w = 0.f;
      if (e < nefc) {
        row_force(s, e, jar[e], &f, &w);
        s.wt()[e] = w;
      }
      add_rows_t(s, e0, f, grad, lane);   // J^T f
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) grad.h[i] = mda.h[i] - grad.h[i];
    PHASE(kForces);

    // H = (J^T W J + qM) + 1e-8 I over the rows of nonzero weight
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) A[ii][jj] = 0.f;
    for (int e0 = 0; e0 < nefc; e0 += 32) {
      const float w = e0 + lane < nefc ? s.wt()[e0 + lane] : 0.f;
      unsigned m = __ballot_sync(kFull, w != 0.f);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const float wb = __shfl_sync(kFull, w, b);
        const float* Je = s.J() + (e0 + b) * ld;
        float jr[TI], jc[TJ];
#pragma unroll
        for (int ii = 0; ii < TI; ++ii)
          jr[ii] = Je[min(lr + 8 * ii, nv - 1)] * wb;
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) jc[jj] = Je[min(lc + 4 * jj, nv - 1)];
#pragma unroll
        for (int ii = 0; ii < TI; ++ii)
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj)
            if (lower(ii, jj)) A[ii][jj] = A[ii][jj] + jr[ii] * jc[jj];
      }
    }
    {
      float Mt[TI][TJ], ridge[TI];
      tile_load<TI>(Mt, M, ld, nv, lr, lc);
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) {
        ridge[ii] = kRidge;
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj)
          if (lower(ii, jj)) A[ii][jj] = A[ii][jj] + Mt[ii][jj];
      }
      tile_add_diag<TI>(A, ridge, lr, lc);
    }
    PHASE(kHessian);
    Vec<NH> p = grad;
    tile_factor<TI>(A, s.H(), nv, lr, lc, p);
    PHASE(kChol);
    p = chol_back(s.H(), nv, p, lane);
#pragma unroll
    for (int i = 0; i < NH; ++i) p.h[i] = -p.h[i];
    PHASE(kSolve);

    stage(s, p, lane);   // J p and qM p from one staging of p
    for (int e = lane; e < nefc; e += 32)
      s.jp()[e] = row_dot(s, s.J() + e * ld);
    const Vec<NH> mp = qM_rows<NH>(s, lane);
    const float g0 = warp_sum(lane_dot(p, mda, nv, lane));
    const float pmp = warp_sum(lane_dot(p, mp, nv, lane));
    float alpha = 1.f;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float sf = 0.f, sw = 0.f;
      for (int e = lane; e < nefc; e += 32) {
        float f, w;
        const float jpe = s.jp()[e];
        row_force(s, e, jar[e] + alpha * jpe, &f, &w);
        sf += f * jpe;
        sw += w * jpe * jpe;
      }
      const float dphi = g0 + alpha * pmp - warp_sum(sf);
      const float ddphi = pmp + warp_sum(sw);
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, kEps), 0.f), 4.f);
    }
    Vec<NH> a_new;
#pragma unroll
    for (int i = 0; i < NH; ++i) a_new.h[i] = a.h[i] + alpha * p.h[i];
    PHASE(kLineSearch);
    Vec<NH> mda_new;
    const float cost_new =
        total_cost(s, a_new, as, lane, s.jar(cur ^ 1), mda_new);
    if (cost_new <= cost) {
      a = a_new;
      cost = cost_new;
      mda = mda_new;
      cur ^= 1;
    }
    PHASE(kAccept);
  }

  // 4. final forces and qfrc
  const float* jar = s.jar(cur);
  Vec<NH> qfrc_r = {};
  for (int e0 = 0; e0 < nefc; e0 += 32) {
    const int e = e0 + lane;
    float f = 0.f, w;
    if (e < nefc) {
      row_force(s, e, jar[e], &f, &w);
      force[r0 + e] = f;
    }
    add_rows_t(s, e0, f, qfrc_r, lane);
  }
  PHASE(kFinal);

  // 5. implicit-damping Euler solve
  float dr[TI];
  const Vec<NH> damph_r = load_vec<NH>(damph + v0, nv, lane);
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
    dr[ii] = __shfl_sync(kFull, damph_r.h[ii >> 2], lr + 8 * (ii & 3));
  tile_load<TI>(A, M, ld, nv, lr, lc);
  tile_add_diag<TI>(A, dr, lr, lc);
  Vec<NH> rhs;
#pragma unroll
  for (int i = 0; i < NH; ++i) rhs.h[i] = qfs_r.h[i] + qfrc_r.h[i];
  const Vec<NH> qe = tile_solve<TI>(A, s.H(), nv, lr, lc, rhs);

  store_vec(qacc + v0, a, nv, lane);
  store_vec(qfrc + v0, qfrc_r, nv, lane);
  store_vec(asmooth + v0, as, nv, lane);
  store_vec(qacc_euler + v0, qe, nv, lane);
  PHASE(kEuler);
#ifdef NEWTON_PHASE_CLOCKS
  __syncwarp();
  if (lane < kPhases) cycles[env * kPhases + lane] = phase_acc[lane];
#endif
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        float*, float*, float*, float*, unsigned long long*,
                        int, int, int, int, int, int);

constexpr int kMaxNv = 40;

// The instantiation for nv (1..kMaxNv): TI = ceil(nv / 8)
Kernel kernel_for(int nv) {
  switch ((nv + 7) / 8) {
    case 1: return newton_solve_kernel<1, 4>;
    case 2: return newton_solve_kernel<2, 4>;
    case 3: return newton_solve_kernel<3, 4>;
    case 4: return newton_solve_kernel<4, 2>;
    default: return newton_solve_kernel<5, 1>;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one env needs.
int newton_solve_smem_per_env(int nv, int nefc) {
  return (int)sizeof(float) * floats_per_env(nv, nefc);
}

// Blocks of `envs_per_block` envs that fit on one SM at once, or a
// negative CUDA error.
int newton_solve_occupancy(int nv, int nefc, int envs_per_block) {
  if (nv < 1 || nv > kMaxNv || nefc < 0 || envs_per_block < 1 ||
      envs_per_block > 8)
    return -(int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(nv);
  const int smem = envs_per_block * newton_solve_smem_per_env(nv, nefc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, 32 * envs_per_block, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// All pointers are device pointers to contiguous float32, batch-first:
// qM (B,nv,nv), J (B,nefc,nv), aref/R/floss/active (B,nefc),
// warm/qfrc_smooth/damph (B,nv); outputs qacc, qfrc, asmooth, qacc_euler
// (B,nv) and force (B,nefc). `cycles` is null, or in the
// NEWTON_PHASE_CLOCKS build a zeroed (B, kPhases) uint64 buffer for the
// phase clocks. At most 8 envs per block (the launch bounds' 256 threads).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int newton_solve_f32(const void* qM, const void* J, const void* aref,
                     const void* R, const void* floss, const void* active,
                     const void* warm, const void* qfrc_smooth,
                     const void* damph, void* qacc, void* qfrc, void* force,
                     void* asmooth, void* qacc_euler, int batch, int nv,
                     int nefc, int n_friction, int iterations,
                     int ls_iterations, int envs_per_block, void* cycles,
                     void* stream) {
  if (batch <= 0) return 0;
  if (nv < 1 || nv > kMaxNv || nefc < 0 || envs_per_block < 1 ||
      envs_per_block > 8)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(nv);
  const size_t smem =
      (size_t)envs_per_block * newton_solve_smem_per_env(nv, nefc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + envs_per_block - 1) / envs_per_block;
  kernel<<<blocks, 32 * envs_per_block, smem, (cudaStream_t)stream>>>(
      (const float*)qM, (const float*)J, (const float*)aref,
      (const float*)R, (const float*)floss, (const float*)active,
      (const float*)warm, (const float*)qfrc_smooth, (const float*)damph,
      (float*)qacc, (float*)qfrc, (float*)force, (float*)asmooth,
      (float*)qacc_euler, (unsigned long long*)cycles, batch, nv, nefc,
      n_friction, iterations, ls_iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"

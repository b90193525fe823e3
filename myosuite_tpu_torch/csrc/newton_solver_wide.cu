// Fused Newton constraint solver, one block per env, sm_90a: the wide route.
//
// Replaces the Pallas TPU kernel `_solver_kernel` in
// myosuite_tpu/physics/pallas_solver.py:95 for the shapes that the warp
// kernel (newton_solver.cu) does not take: nv > 40, where one warp's lanes
// cannot hold a vector two elements at a time, or an env whose working set
// passes the 232,448 bytes of shared memory a block may use (at nv 38 from
// 1,071 rows). newton_kernel.route picks the kernel; every other shape
// stays on the warp kernel. It computes the same function:
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
// Every pivot s is clamped to 1e-12 under the square root and the factor's
// diagonal is s / sqrt(max(s, 1e-12)), so a negative pivot gives a finite
// result.
//
// What bounds it on an H100. At the cluttered Relocate scene's (nv 45,
// nefc 375) one env needs ~1.2e6 FP32 operations at the ~16 rows of
// nonzero weight its solutions have, against ~84 KB of device traffic
// (newton_kernel.flops_per_env, bytes_per_env): ~14 flops per byte, under
// the card's ~20 flops per byte FP32 ridge, so bytes bound it, ~0.10 ms at
// batch 4096. The kernel runs far from that bound: each Newton step is a
// chain of dependent stages (the Cholesky's nv columns, each a square root
// and a division between two block barriers; the backward substitution;
// the line search's sums), and the time is that chain's latency, which
// only more envs in flight per SM hide.
//
// What the design does about it, simply, first:
// - One block of 128 threads per env, so that the wide stages spread over
//   four warps: J x and qM x give each thread a row (k ascending), J^T f a
//   column, J^T W J a set of entries of the lower triangle, each thread
//   holding up to 4 of them in registers while it walks the rows of
//   nonzero weight in ascending order, and the Cholesky's trailing update
//   its rows. A block barrier separates the stages.
// - The rows of nonzero weight and of nonzero force are listed once per
//   iteration (a ballot per 32 rows), so J^T W J and J^T f touch only them.
//   A skipped row adds +-0 to a sum that starts at +0, which changes no bit.
// - The Cholesky is right-looking, two barriers per column, each thread
//   updating whole rows of the trailing triangle, with the forward
//   substitution riding along; the backward substitution and every
//   sum over a whole vector (the costs, the line search) run in warp 0 alone.
// - J is read from the input in device memory in each pass (through L1
//   and L2), never staged: at the scene J is 67.5 KB of an env's 98, and
//   staging it held an SM to 2 envs; without it, and with the registers
//   capped at 80 (some spill), 6 fit, and a launch at batch 4096 on an
//   H100 took 5.4 ms, not 9.8 (PERF.md). qM (rows of odd stride, so that
//   threads walking rows meet no bank conflict), the triangle and the
//   vectors live in shared memory where they fit, else in a per-env
//   workspace in device memory that the wrapper allocates; only the place
//   of the data changes, never the arithmetic. So the kernel has no limit
//   of its own on (nv, nefc) but device memory.
//
// Every sum keeps the order of the warp kernel and of the plain PyTorch
// version (newton_kernel.newton_solve_reference, which is also this kernel's
// plain version): dot products over k ascending, J^T W J and J^T f over rows
// ascending, the Cholesky's subtractions over k ascending, the cost and
// line-search sums in warp 0's order (lane l takes entries l, l + 32, ...,
// then a butterfly over the lanes). Built with -fmad=false, so the kernel,
// its plain version and the warp kernel agree to the last bit at any shape
// that more than one of them takes.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;
constexpr float kRidge = 1e-8f;
constexpr int kThreads = 128;        // one block per env
constexpr int kMinBlocks = 6;        // blocks per SM the registers allow
constexpr int kTile = 4;             // J^T W J entries a thread holds
constexpr int kRowBatch = 4;         // Cholesky entries a thread loads at once
constexpr long kSmemLimit = 232448;  // dynamic shared memory of a block

// One env's vectors, in this order. nv-vectors: a_smooth, the current and
// the candidate point (their roles swap when the candidate is taken), qM (a
// - a_smooth) of each, the Newton direction (grad, then p, then the Euler
// right-hand side), a scratch vector (a - a_smooth, qM p), qfrc_smooth,
// damping, qfrc. Row vectors: aref, 1 / R, floss, active, J a - aref of
// each point, J p, the weights, the forces and the two row lists.
enum NvVec { kAs, kA0, kA1, kMda0, kMda1, kP, kTmp, kQfs, kDamph, kQfrc,
             kNvVecs };
enum RowVec { kAref, kRinv, kFloss, kActive, kJar0, kJar1, kJp, kW, kF,
              kListW, kListF, kRowVecs };
// scalars at the head of shared memory: a cost, alpha, the list lengths
enum Scalar { kCost, kAlpha, kNw, kNf, kScalars };

// Phases of the solve timed by the NEWTON_PHASE_CLOCKS build (names in
// newton_kernel.PHASES, as the warp kernel's): at the end of each, a block
// barrier, then thread 0 adds the clock64() cycles since the last stamp to
// a register of its own; the counters go to cycles[env * kPhases + phase]
// at the end. The barriers are the build's only difference. Off in the
// build the main path loads.
constexpr int kPhases = 11;
enum Phase { kStaging, kSmooth, kWarm, kForces, kHessian, kChol, kSolve,
             kLineSearch, kAccept, kFinal, kEuler };
#ifdef NEWTON_PHASE_CLOCKS
#define PHASE(ph)                                \
  do {                                           \
    __syncthreads();                             \
    if (t == 0) {                                \
      const long long now = clock64();           \
      phase_acc[ph] += (unsigned long long)(now - t_phase); \
      t_phase = now;                             \
    }                                            \
  } while (0)
#else
#define PHASE(ph) ((void)0)
#endif

// Indices within one env are ints (an env's J would need 8 GB to pass
// them); only offsets across envs are 64-bit.
__host__ __device__ inline int tri(int r) { return r * (r + 1) / 2; }
// row stride of qM where it is staged: odd
__host__ __device__ inline int row_ld(int nv) { return nv | 1; }

// floats of one env's triangle and vectors (the workspace, when not staged)
__host__ __device__ inline long work_floats(int nv, int nefc) {
  return tri(nv) + kNvVecs * nv + kRowVecs * nefc;
}
// floats of one env's working set in shared memory: qM, the triangle, the
// vectors (J is read from device memory)
__host__ __device__ inline long staged_floats(int nv, int nefc) {
  return kScalars + nv * row_ld(nv) + work_floats(nv, nefc);
}
inline bool staged(int nv, int nefc) {
  return 4 * staged_floats(nv, nefc) <= kSmemLimit;
}
inline size_t smem_bytes(int nv, int nefc) {
  return 4 * (staged(nv, nefc) ? staged_floats(nv, nefc) : kScalars);
}

struct Sys {
  const float* M;   // qM, rows of stride ldm
  const float* J;   // J, rows of stride nv, in device memory
  float* H;         // lower triangle, packed by rows (row r at tri(r))
  float* v;         // nv-vectors
  float* r;         // row vectors
  float* sc;        // scalars
  int nv, nefc, nfr, ldm;
  __device__ __forceinline__ float* vec(int i) const { return v + i * nv; }
  __device__ __forceinline__ float* row(int i) const { return r + i * nefc; }
  __device__ __forceinline__ int* list(int i) const {
    return reinterpret_cast<int*>(row(i));
  }
  __device__ __forceinline__ int* count() const {
    return reinterpret_cast<int*>(sc);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The packed index q of the lower triangle as (row a, column b), b <= a
__device__ __forceinline__ void unpack(int q, int& a, int& b) {
  a = (int)((sqrtf(8.f * (float)q + 1.f) - 1.f) * 0.5f);
  while (tri(a + 1) <= q) ++a;
  while (tri(a) > q) --a;
  b = q - tri(a);
}

// (a, b) moved on by `step` packed entries
__device__ __forceinline__ void advance(int& a, int& b, int step) {
  b += step;
  while (b > a) {
    b -= a + 1;
    ++a;
  }
}

// sum_k row[k] x[k] over k ascending
__device__ __forceinline__ float row_dot(const float* row, const float* x,
                                         int nv) {
  float acc = 0.f;
  for (int k = 0; k < nv; ++k) acc = acc + row[k] * x[k];
  return acc;
}

// Warp 0's part of sum_i a_i b_i before the butterfly: lane l takes
// elements l, l + 32, ...
__device__ __forceinline__ float lane_dot(const float* a, const float* b,
                                          int n, int lane) {
  float acc = lane < n ? a[lane] * b[lane] : 0.f;
  for (int i = lane + 32; i < n; i += 32) acc = acc + a[i] * b[i];
  return acc;
}

__device__ __forceinline__ void row_force(const Sys& s, int e, float jar,
                                          float* force, float* w) {
  float ri = s.row(kRinv)[e];
  float quad_f = -jar * ri;
  if (e < s.nfr) {
    float fl = s.row(kFloss)[e];
    *force = fminf(fmaxf(quad_f, -fl), fl);
    *w = fabsf(quad_f) < fl ? ri : 0.f;
  } else {
    float on = (s.row(kActive)[e] != 0.f && jar < 0.f) ? 1.f : 0.f;
    *force = on * quad_f;
    *w = on * ri;
  }
}

__device__ __forceinline__ float row_cost(const Sys& s, int e, float jar) {
  float ri = s.row(kRinv)[e];
  float quad = 0.5f * jar * jar * ri;
  if (e < s.nfr) {
    float fl = s.row(kFloss)[e];
    float band = fl / fmaxf(ri, kEps);
    return fabsf(jar) < band ? quad : fl * fabsf(jar) - 0.5f * fl * band;
  }
  return (s.row(kActive)[e] != 0.f && jar < 0.f) ? quad : 0.f;
}

// 0.5 (a - as)^T qM (a - as) + sum_e cost_e(J_e a - aref_e), the same in
// every thread; leaves qM (a - as) in mda and J a - aref in jar, from which
// the next iteration starts if the point is taken.
__device__ float total_cost(const Sys& s, const float* a, float* jar,
                            float* mda, int t) {
  float* da = s.vec(kTmp);
  const float* as = s.vec(kAs);
  for (int i = t; i < s.nv; i += kThreads) da[i] = a[i] - as[i];
  __syncthreads();
  for (int q = t; q < s.nv + s.nefc; q += kThreads) {
    if (q < s.nv) {
      mda[q] = row_dot(s.M + q * s.ldm, da, s.nv);
    } else {
      const int e = q - s.nv;
      jar[e] = row_dot(s.J + e * s.nv, a, s.nv) - s.row(kAref)[e];
    }
  }
  __syncthreads();
  if (t < 32) {
    const float qpart = lane_dot(da, mda, s.nv, t);
    float c = 0.f;
    for (int e = t; e < s.nefc; e += 32) c += row_cost(s, e, jar[e]);
    const float cost = 0.5f * warp_sum(qpart) + warp_sum(c);
    if (t == 0) s.sc[kCost] = cost;
  }
  __syncthreads();
  return s.sc[kCost];
}

// Warp 0: the row forces and weights at jar into kF and kW, and the rows of
// nonzero weight and of nonzero force listed in ascending order
__device__ void forces_and_lists(const Sys& s, const float* jar, int lane) {
  int nw = 0, nf = 0;
  int* lw = s.list(kListW);
  int* lf = s.list(kListF);
  const unsigned below = (1u << lane) - 1u;
  for (int e0 = 0; e0 < s.nefc; e0 += 32) {
    const int e = e0 + lane;
    float f = 0.f, w = 0.f;
    if (e < s.nefc) {
      row_force(s, e, jar[e], &f, &w);
      s.row(kF)[e] = f;
      s.row(kW)[e] = w;
    }
    const unsigned mw = __ballot_sync(kFull, w != 0.f);
    const unsigned mf = __ballot_sync(kFull, f != 0.f);
    if (w != 0.f) lw[nw + __popc(mw & below)] = e;
    if (f != 0.f) lf[nf + __popc(mf & below)] = e;
    nw += __popc(mw);
    nf += __popc(mf);
  }
  if (lane == 0) {
    s.count()[kNw] = nw;
    s.count()[kNf] = nf;
  }
}

// out[i] = sum_e J[e, i] f_e over the listed rows of nonzero force
__device__ __forceinline__ float column_force(const Sys& s, int i, int nf) {
  const int* lf = s.list(kListF);
  const float* f = s.row(kF);
  float acc = 0.f;
  for (int n = 0; n < nf; ++n) {
    const int e = lf[n];
    acc += s.J[e * s.nv + i] * f[e];
  }
  return acc;
}

// H = lower triangle of qM, plus diag on the diagonal (+0 elsewhere, as the
// plain version adds a diagonal matrix) where diag is given
__device__ void fill_h(const Sys& s, const float* diag, int t) {
  const int n = tri(s.nv);
  if (t >= n) return;
  int a, b;
  unpack(t, a, b);
  for (int q = t; q < n; q += kThreads, advance(a, b, kThreads)) {
    const float m = s.M[a * s.ldm + b];
    s.H[q] = diag ? m + (a == b ? diag[a] : 0.f) : m;
  }
}

// H = (J^T W J + qM) + 1e-8 I over the listed rows of nonzero weight; each
// thread sums up to kTile entries at a time over the rows in ascending order
__device__ void hessian(const Sys& s, int nw, int t) {
  const int n = tri(s.nv);
  const int* lw = s.list(kListW);
  const float* w = s.row(kW);
  for (int q0 = t; q0 < n; q0 += kThreads * kTile) {
    int ri[kTile], ci[kTile];
    float acc[kTile];
    int a, b;
    unpack(q0, a, b);
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      ri[k] = min(a, s.nv - 1);   // past the end: read in range, not stored
      ci[k] = min(b, s.nv - 1);
      acc[k] = 0.f;
      advance(a, b, kThreads);
    }
    for (int m = 0; m < nw; ++m) {
      const int e = lw[m];
      const float we = w[e];
      const float* Je = s.J + e * s.nv;
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        acc[k] = acc[k] + (Je[ri[k]] * we) * Je[ci[k]];
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int q = q0 + k * kThreads;
      if (q < n)
        s.H[q] = (acc[k] + s.M[ri[k] * s.ldm + ci[k]]) +
                 (ri[k] == ci[k] ? kRidge : 0.f);
    }
  }
}

// In-place right-looking Cholesky of H with the forward substitution of b
// (which becomes y, L y = b) riding along. Column k: d = sqrt(max(S_kk,
// eps)), L_ik = S_ik / d for i >= k, y_k = b_k / L_kk; then b_i -= L_ik y_k
// and S_ij -= L_ik L_jk for k < j <= i, so each entry subtracts over k
// ascending; a thread takes whole rows i of the trailing triangle, whose
// L_jk it reads as all threads do, in step. The diagonal is written in the
// second stage, which reads no diagonal entry of column k. Starts and ends
// at a barrier.
__device__ void factor(const Sys& s, float* b, int t) {
  float* H = s.H;
  const int nv = s.nv;
  for (int k = 0; k < nv; ++k) {
    const int dk = tri(k) + k;
    const float piv = H[dk];
    const float d = sqrtf(fmaxf(piv, kEps));
    for (int i = k + 1 + t; i < nv; i += kThreads)
      H[tri(i) + k] = H[tri(i) + k] / d;
    float lkk = 0.f;
    if (t == 0) {
      lkk = piv / d;
      b[k] = b[k] / lkk;
    }
    __syncthreads();
    if (t == 0) H[dk] = lkk;
    const float yk = b[k];
    for (int i = k + 1 + t; i < nv; i += kThreads) {
      float* row = H + tri(i);
      const float lik = row[k];
      b[i] = b[i] - lik * yk;
      // row[j] -= lik L_jk for k < j <= i, kRowBatch at a time: a batch's
      // loads go out together (the stores of one batch would otherwise
      // hold back the loads of the next; they never meet column k)
      int j = k + 1, off = tri(j) + k;   // L_jk at H[off]
      for (; j + kRowBatch - 1 <= i; j += kRowBatch) {
        float l[kRowBatch], r[kRowBatch];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          l[u] = H[off];
          off += j + u + 1;
          r[u] = row[j + u];
        }
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) row[j + u] = r[u] - lik * l[u];
      }
      for (; j <= i; ++j, off += j) row[j] = row[j] - lik * H[off];
    }
    __syncthreads();
  }
}

// Warp 0: solve L^T x = y in place, rows from the last
__device__ void back_solve(const Sys& s, float* x, int lane) {
  const float* L = s.H;
  for (int i = s.nv - 1; i >= 0; --i) {
    if (lane == 0) x[i] = x[i] / L[tri(i) + i];
    __syncwarp();
    const float xi = x[i];
    for (int j = lane; j < i; j += 32) x[j] = x[j] - L[tri(i) + j] * xi;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) newton_wide_kernel(
    const float* __restrict__ qM, const float* __restrict__ J,
    const float* __restrict__ aref, const float* __restrict__ R,
    const float* __restrict__ floss, const float* __restrict__ active,
    const float* __restrict__ warm, const float* __restrict__ qfs,
    const float* __restrict__ damph, float* __restrict__ qacc,
    float* __restrict__ qfrc, float* __restrict__ force,
    float* __restrict__ asmooth, float* __restrict__ qacc_euler,
    float* __restrict__ work, unsigned long long* __restrict__ cycles,
    int in_smem, int nv, int nefc, int nfr, int iterations,
    int ls_iterations) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
#ifdef NEWTON_PHASE_CLOCKS
  unsigned long long phase_acc[kPhases] = {};
  long long t_phase = clock64();
#endif
  const long env = blockIdx.x;
  const long v0 = env * nv, r0 = env * nefc;
  const float* gM = qM + env * nv * nv;
  Sys s;
  s.nv = nv;
  s.nefc = nefc;
  s.nfr = nfr;
  s.sc = smem;
  float* base;
  if (in_smem) {
    const int ld = row_ld(nv);
    float* M = smem + kScalars;
    for (int i = t; i < nv * nv; i += kThreads)
      M[(i / nv) * ld + i % nv] = gM[i];
    s.M = M;
    s.ldm = ld;
    base = M + nv * ld;
  } else {
    s.M = gM;
    s.ldm = nv;
    base = work + env * work_floats(nv, nefc);
  }
  s.J = J + env * nefc * nv;
  s.H = base;
  s.v = base + tri(nv);
  s.r = s.v + kNvVecs * nv;
  for (int e = t; e < nefc; e += kThreads) {
    s.row(kAref)[e] = aref[r0 + e];
    s.row(kRinv)[e] = 1.f / R[r0 + e];
    s.row(kFloss)[e] = floss[r0 + e];
    s.row(kActive)[e] = active[r0 + e];
  }
  for (int i = t; i < nv; i += kThreads) {
    s.vec(kQfs)[i] = qfs[v0 + i];
    s.vec(kAs)[i] = qfs[v0 + i];
    s.vec(kDamph)[i] = damph[v0 + i];
    s.vec(kA0)[i] = warm[v0 + i];
  }
  __syncthreads();
  PHASE(kStaging);

  // 1. a_smooth
  fill_h(s, nullptr, t);
  __syncthreads();
  factor(s, s.vec(kAs), t);
  if (t < 32) back_solve(s, s.vec(kAs), t);
  __syncthreads();
  for (int i = t; i < nv; i += kThreads) s.vec(kA1)[i] = s.vec(kAs)[i];
  __syncthreads();
  PHASE(kSmooth);

  // 2. warm start: point 0 is the warm start, point 1 a_smooth; the current
  // one comes with its cost, qM (a - as) and J a - aref
  const float cost_w = total_cost(s, s.vec(kA0), s.row(kJar0),
                                  s.vec(kMda0), t);
  const float cost_s = total_cost(s, s.vec(kA1), s.row(kJar1),
                                  s.vec(kMda1), t);
  int cur = cost_w < cost_s ? 0 : 1;
  float cost = cur ? cost_s : cost_w;
  PHASE(kWarm);

  // 3. Newton iterations
  float* p = s.vec(kP);
  for (int it = 0; it < iterations; ++it) {
    const float* a = s.vec(kA0 + cur);
    const float* mda = s.vec(kMda0 + cur);
    const float* jar = s.row(kJar0 + cur);
    if (t < 32) forces_and_lists(s, jar, t);
    __syncthreads();
    const int nw = s.count()[kNw], nf = s.count()[kNf];
    for (int i = t; i < nv; i += kThreads)
      p[i] = mda[i] - column_force(s, i, nf);
    PHASE(kForces);
    hessian(s, nw, t);
    __syncthreads();
    PHASE(kHessian);
    factor(s, p, t);
    PHASE(kChol);
    if (t < 32) {
      back_solve(s, p, t);
      for (int i = t; i < nv; i += 32) p[i] = -p[i];
    }
    __syncthreads();
    PHASE(kSolve);

    // J p and qM p, then the line search in warp 0
    float* mp = s.vec(kTmp);
    float* jp = s.row(kJp);
    for (int q = t; q < nv + nefc; q += kThreads) {
      if (q < nv) mp[q] = row_dot(s.M + q * s.ldm, p, nv);
      else jp[q - nv] = row_dot(s.J + (q - nv) * nv, p, nv);
    }
    __syncthreads();
    if (t < 32) {
      const float g0 = warp_sum(lane_dot(p, mda, nv, t));
      const float pmp = warp_sum(lane_dot(p, mp, nv, t));
      float alpha = 1.f;
      for (int ls = 0; ls < ls_iterations; ++ls) {
        float sf = 0.f, sw = 0.f;
        for (int e = t; e < nefc; e += 32) {
          float f, w;
          const float jpe = jp[e];
          row_force(s, e, jar[e] + alpha * jpe, &f, &w);
          sf += f * jpe;
          sw += w * jpe * jpe;
        }
        const float dphi = g0 + alpha * pmp - warp_sum(sf);
        const float ddphi = pmp + warp_sum(sw);
        alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, kEps), 0.f), 4.f);
      }
      if (t == 0) s.sc[kAlpha] = alpha;
    }
    __syncthreads();
    const float alpha = s.sc[kAlpha];
    float* a_new = s.vec(kA0 + (cur ^ 1));
    for (int i = t; i < nv; i += kThreads) a_new[i] = a[i] + alpha * p[i];
    __syncthreads();
    PHASE(kLineSearch);
    const float cost_new = total_cost(s, a_new, s.row(kJar0 + (cur ^ 1)),
                                      s.vec(kMda0 + (cur ^ 1)), t);
    if (cost_new <= cost) {
      cost = cost_new;
      cur ^= 1;
    }
    PHASE(kAccept);
  }

  // 4. final forces and qfrc; the Euler right-hand side into p
  if (t < 32) forces_and_lists(s, s.row(kJar0 + cur), t);
  __syncthreads();
  for (int e = t; e < nefc; e += kThreads) force[r0 + e] = s.row(kF)[e];
  const int nf = s.count()[kNf];
  for (int i = t; i < nv; i += kThreads) {
    const float q = column_force(s, i, nf);
    qfrc[v0 + i] = q;
    p[i] = s.vec(kQfs)[i] + q;
  }
  PHASE(kFinal);

  // 5. implicit-damping Euler solve
  fill_h(s, s.vec(kDamph), t);
  __syncthreads();
  factor(s, p, t);
  if (t < 32) back_solve(s, p, t);
  __syncthreads();
  const float* a = s.vec(kA0 + cur);
  for (int i = t; i < nv; i += kThreads) {
    qacc[v0 + i] = a[i];
    asmooth[v0 + i] = s.vec(kAs)[i];
    qacc_euler[v0 + i] = p[i];
  }
  PHASE(kEuler);
#ifdef NEWTON_PHASE_CLOCKS
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) cycles[env * kPhases + i] = phase_acc[i];
  }
#endif
}

}  // namespace

extern "C" {

// Floats of the per-env workspace in device memory that a launch at these
// sizes needs: 0 where one env's working set fits in shared memory.
long newton_wide_workspace_floats(int nv, int nefc) {
  return staged(nv, nefc) ? 0 : work_floats(nv, nefc);
}

// Bytes of dynamic shared memory of one block (one env).
long newton_wide_smem_bytes(int nv, int nefc) {
  return (long)smem_bytes(nv, nefc);
}

// Blocks that fit on one SM at once at these sizes, or a negative CUDA
// error.
int newton_wide_occupancy(int nv, int nefc) {
  if (nv < 1 || nefc < 0) return -(int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(nv, nefc);
  cudaError_t err = cudaFuncSetAttribute(
      newton_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, newton_wide_kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// All pointers are device pointers to contiguous float32, batch-first:
// qM (B,nv,nv), J (B,nefc,nv), aref/R/floss/active (B,nefc),
// warm/qfrc_smooth/damph (B,nv); outputs qacc, qfrc, asmooth, qacc_euler
// (B,nv) and force (B,nefc). `work` holds batch *
// newton_wide_workspace_floats(nv, nefc) floats (null when that is 0).
// `cycles` is null, or in the NEWTON_PHASE_CLOCKS build a (B, kPhases)
// uint64 buffer for the phase clocks. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int newton_wide_f32(const void* qM, const void* J, const void* aref,
                    const void* R, const void* floss, const void* active,
                    const void* warm, const void* qfrc_smooth,
                    const void* damph, void* qacc, void* qfrc, void* force,
                    void* asmooth, void* qacc_euler, void* work,
                    void* cycles, int batch, int nv, int nefc,
                    int n_friction, int iterations, int ls_iterations,
                    void* stream) {
  if (batch <= 0) return 0;
  const bool in_smem = staged(nv, nefc);
  if (nv < 1 || nefc < 0 || (!in_smem && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nv, nefc);
  cudaError_t err = cudaFuncSetAttribute(
      newton_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  newton_wide_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)qM, (const float*)J, (const float*)aref,
      (const float*)R, (const float*)floss, (const float*)active,
      (const float*)warm, (const float*)qfrc_smooth, (const float*)damph,
      (float*)qacc, (float*)qfrc, (float*)force, (float*)asmooth,
      (float*)qacc_euler, (float*)work, (unsigned long long*)cycles,
      in_smem ? 1 : 0, nv, nefc, n_friction, iterations, ls_iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// batch 4096. The kernel runs far from that bound. A Newton step is a chain
// of dependent stages, but with 6 or more envs per SM the SM, not the
// chain, sets the pace: each env's cycles grow with the envs beside it
// (PERF.md), so what counts is the work each env issues, its
// spills, and the L1 left for the passes over J, which each thread walks
// row by row from device memory. So a launch asks for the smallest split
// of the SM's 256 KB that holds the blocks its registers allow
// (`carveout`): at the scene 196 KB of shared memory, leaving 60 KB of
// L1; chip_smoke.py phase 16 times it against the largest split (28 KB of
// L1) and the CUDA runtime's default at the same blocks per SM.
//
// The design:
// - One block of 128 threads per env. J x and qM x give each thread a row
//   (k ascending), J^T f a column, J^T W J a set of entries of the lower
//   triangle, each thread holding kTile of them in registers while it walks
//   the rows of nonzero weight in ascending order. A block barrier
//   separates the stages.
// - The rows of nonzero weight and of nonzero force are listed once per
//   iteration (a ballot per 32 rows), so J^T W J and J^T f touch only them.
//   A skipped row adds +-0 to a sum that starts at +0, which changes no bit.
// - The Cholesky goes by entries, two columns a step and two block
//   barriers a step, so one a column (`factor`, `pair_step`): the block
//   forms the pair's columns of L once, a row a thread, then all 128
//   threads update the trailing triangle by entries of it in packed order,
//   each entry taking both columns' terms in order with one paired load of
//   each L row; the entries' places come from a table, as no thread has
//   the registers to hold its own. The forward substitution rides along.
//   Once at most kWarpFinish rows lie below a pair, warp 0 finishes under
//   __syncwarp and goes straight on to the backward substitution, whose
//   x_i reach the lanes by a shuffle: every other x_j stays with the one
//   lane that updates it.
// - The row evaluations run on all four warps: the thread that computes
//   J_e a - aref_e also computes the row's cost, and in each line-search
//   step every thread computes f_e Jp_e and w_e Jp_e^2 for its rows, into
//   shared memory. The sums over rows then read those values in warp 0's
//   order; the line search's run in every warp at once (each gets the same
//   alpha), from buffers that alternate between steps, so a step costs one
//   barrier.
// - 8 envs per SM at the scene, limited by registers (64 a thread,
//   `kMinBlocks`) within the 196 KB split the launch asks for: 24,016 bytes an
//   env, so 8 x (24,016 + 1,024 reserved) <= 200,704. Batch 4096 runs in 3.9
//   waves of 132 x 8, not 5.2 of 132 x 6. For that, aref, R (1 / R is formed
//   where it is used, the same IEEE division), floss, active, qfrc_smooth and
//   the damping are read from the inputs where they are used; the line search's
//   and the costs' buffers, and the factor's pair buffer, live in row vectors
//   that are dead there; J^T W J holds 2 entries a thread, not 4, so that 64
//   registers need no spills. J is read from the input in device memory in each
//   pass, never staged (staging its rows through shared memory by cp.async was
//   1.5x slower). qM (rows of odd stride, so that threads walking rows meet no
//   bank conflict), the triangle, the pair buffer and the vectors live in
//   shared memory where they fit, else in a per-env workspace in device memory
//   that the wrapper allocates; the kernel is compiled for each of the two
//   places, so that shared memory is addressed as such. Only the place of the
//   data changes, never the arithmetic, so the kernel has no limit of its own
//   on (nv, nefc) but device memory.
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
constexpr int kMinBlocks = 8;        // blocks per SM: at most 64 registers
constexpr int kTile = 2;             // J^T W J entries a thread holds
constexpr int kWarpFinish = 15;      // rows below a pair: warp 0 alone
constexpr long kSmemLimit = 232448;  // dynamic shared memory of a block

// One env's vectors, in this order. nv-vectors: a_smooth, the current and
// the candidate point (their roles swap when the candidate is taken), qM (a
// - a_smooth) of each, the Newton direction (grad, then p, then the Euler
// right-hand side), a scratch vector (a - a_smooth, qM p). Row vectors:
// J a - aref of each point, J p (which holds the factor's pair buffer
// during a factorization, where it is long enough), the weights, the
// forces and the two row lists (the last four also hold the line search's
// terms, the first of them the row costs).
enum NvVec { kAs, kA0, kA1, kMda0, kMda1, kP, kTmp, kNvVecs };
enum RowVec { kJar0, kJar1, kJp, kW, kF, kListW, kListF, kRowVecs };
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

// The factor's pair buffer: 2 nv floats and 5 scalars, and one float to
// align it to 8 bytes for paired loads. It lives in the row vector of J p,
// which no factorization overlaps, where that is long enough, else in
// floats of its own after the row vectors.
__host__ __device__ inline bool lw_in_jp(int nv, int nefc) {
  return nefc >= 2 * nv + 7;
}
__host__ __device__ inline int lw_floats(int nv, int nefc) {
  return lw_in_jp(nv, nefc) ? 0 : 2 * nv + 6;
}
// floats of one env's triangle, vectors and pair buffer (the workspace,
// when not staged; even, so that every env's starts 8-byte aligned)
__host__ __device__ inline long work_floats(int nv, int nefc) {
  const long n = tri(nv) + kNvVecs * nv + kRowVecs * nefc +
                 lw_floats(nv, nefc);
  return n + (n & 1);
}
// floats of one env's working set in shared memory: qM, the triangle, the
// vectors and the pair buffer (J is read from device memory)
__host__ __device__ inline long staged_floats(int nv, int nefc) {
  return kScalars + nv * row_ld(nv) + tri(nv) + kNvVecs * nv +
         kRowVecs * nefc + lw_floats(nv, nefc);
}
inline bool staged(int nv, int nefc) {
  return 4 * staged_floats(nv, nefc) <= kSmemLimit;
}
inline size_t smem_bytes(int nv, int nefc) {
  return 4 * (staged(nv, nefc) ? staged_floats(nv, nefc) : kScalars);
}

struct Sys {
  const float* M;      // qM, rows of stride ldm
  const float* J;      // J, rows of stride nv, in device memory
  const float* aref;   // this env's inputs, in device memory
  const float* R;
  const float* floss;
  const float* active;
  const float* qfs;
  const float* damph;
  float* H;            // lower triangle, packed by rows (row r at tri(r))
  float* lw;           // the factor's pair buffer
  float* v;            // nv-vectors
  float* r;            // row vectors
  float* sc;           // scalars
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

// lane l's part of sum_e x_e before the butterfly: 0 + x_l + x_{l+32} + ...
__device__ __forceinline__ float lane_sum(const float* x, int n, int lane) {
  float acc = 0.f;
  for (int e = lane; e < n; e += 32) acc += x[e];
  return acc;
}

// 1 / R_e, and floss_e on a friction row or active_e on a limit row, from
// the inputs (not staged: their 3 nefc floats would cost the scene its
// eighth env per SM, or L1)
__device__ __forceinline__ float rinv(const Sys& s, int e) {
  return 1.f / s.R[e];
}
__device__ __forceinline__ float flact(const Sys& s, int e) {
  return e < s.nfr ? s.floss[e] : s.active[e];
}

__device__ __forceinline__ void row_force(const Sys& s, int e, float jar,
                                          float* force, float* w) {
  float ri = rinv(s, e);
  float quad_f = -jar * ri;
  if (e < s.nfr) {
    float fl = flact(s, e);
    *force = fminf(fmaxf(quad_f, -fl), fl);
    *w = fabsf(quad_f) < fl ? ri : 0.f;
  } else {
    float on = (flact(s, e) != 0.f && jar < 0.f) ? 1.f : 0.f;
    *force = on * quad_f;
    *w = on * ri;
  }
}

__device__ __forceinline__ float row_cost(const Sys& s, int e, float jar) {
  float ri = rinv(s, e);
  float quad = 0.5f * jar * jar * ri;
  if (e < s.nfr) {
    float fl = flact(s, e);
    float band = fl / fmaxf(ri, kEps);
    return fabsf(jar) < band ? quad : fl * fabsf(jar) - 0.5f * fl * band;
  }
  return (flact(s, e) != 0.f && jar < 0.f) ? quad : 0.f;
}

// out_e = J_e x (- aref_e where `cost` is set, the row's cost then into
// rc_e) for every row, each sum over k ascending: thread t walks rows t,
// t + 128, ... of J in place.
__device__ void j_rows(const Sys& s, const float* x, float* out, float* rc,
                       bool cost, int t) {
  for (int e = t; e < s.nefc; e += kThreads) {
    const float acc = row_dot(s.J + e * s.nv, x, s.nv);
    if (cost) {
      const float j = acc - s.aref[e];
      out[e] = j;
      rc[e] = row_cost(s, e, j);
    } else {
      out[e] = acc;
    }
  }
}

// 0.5 (a - as)^T qM (a - as) + sum_e cost_e(J_e a - aref_e), the same in
// every thread; leaves qM (a - as) in mda and J a - aref in jar, from which
// the next iteration starts if the point is taken. The thread that computes
// a row's J_e a - aref_e computes its cost too; warp 0 adds them.
__device__ float total_cost(const Sys& s, const float* a, float* jar,
                            float* mda, int t) {
  float* da = s.vec(kTmp);
  float* rc = s.row(kW);   // the row costs
  const float* as = s.vec(kAs);
  for (int i = t; i < s.nv; i += kThreads) da[i] = a[i] - as[i];
  __syncthreads();
  for (int i = t; i < s.nv; i += kThreads)
    mda[i] = row_dot(s.M + i * s.ldm, da, s.nv);
  j_rows(s, a, jar, rc, true, t);
  __syncthreads();
  if (t < 32) {
    const float qpart = lane_dot(da, mda, s.nv, t);
    const float c = lane_sum(rc, s.nefc, t);
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

// The place (row a, column b) of entry m of a packed lower triangle, b <=
// a, for m < kPlaces: one table for every env, read through the read-only
// path (a thread's places are the same for every column, but 64 registers
// cannot hold them).
constexpr int kPlaces = 1024;
struct PlaceTable {
  unsigned short ab[kPlaces];   // a | b << 8
  constexpr PlaceTable() : ab() {
    int a = 0, b = 0;
    for (int m = 0; m < kPlaces; ++m) {
      ab[m] = (unsigned short)(a | b << 8);
      if (++b > a) {
        ++a;
        b = 0;
      }
    }
  }
};
__device__ const PlaceTable kPlaceTable;

__device__ __forceinline__ void place(int m, int& a, int& b) {
  if (m < kPlaces) {
    const unsigned ab = __ldg(&kPlaceTable.ab[m]);
    a = ab & 0xff;
    b = ab >> 8;
  } else {
    unpack(m, a, b);
  }
}

template <int kN>
__device__ __forceinline__ void step_sync() {
  if constexpr (kN == kThreads) __syncthreads();
  else __syncwarp();
}

// Columns k and k + 1 of the factor, by kN threads (t < kN: the block
// under block barriers, or warp 0 under __syncwarp). After the sync that
// ends the step before, column k is final and column k + 1 lacks only
// column k's term. Phase 1: each thread that takes a row i > k + 1 forms
// L_ik = S_ik / d_k, d_k = sqrt(max(S_kk, eps)), then column k + 1's
// S_{i,k+1} - L_ik L_{k+1,k} (the operations of that entry's update in
// column k) and L_{i,k+1} = that / d_{k+1}, writes both into place and
// into the pair buffer lw (lw[2x], lw[2x + 1] for row k + 2 + x), which
// nobody else reads or writes in this phase; thread kN - 1 forms L_kk,
// L_{k+1,k}, L_{k+1,k+1}, y_k and y_{k+1} into lw's scalars. Phase 2: the
// trailing triangle below k + 1 by entries, S_ij = (S_ij - L_ik L_jk) -
// L_{i,k+1} L_{j,k+1}, a thread taking entries t, t + kN, ... of it in
// packed order, two at a time; b_i = (b_i - L_ik y_k) - L_{i,k+1} y_{k+1}
// by the rows' threads; the scalars into place, where nobody reads them
// in this phase.
template <int kN>
__device__ __forceinline__ void pair_step(float* H, float* b, float* lw,
                                          int nv, int k, int t) {
  const int c = k + 2, n = nv - c;   // rows below k + 1
  float* sc = lw + 2 * nv;           // L_kk, L_{k+1,k}, L_{k+1,k+1}, y
  const float p0 = H[tri(k) + k];
  const float d0 = sqrtf(fmaxf(p0, kEps));
  const float l10 = H[tri(k + 1) + k] / d0;
  const float p1 = H[tri(k + 1) + k + 1] - l10 * l10;
  const float d1 = sqrtf(fmaxf(p1, kEps));
  for (int x = t; x < n; x += kN) {
    const int r = tri(c + x);
    const float la = H[r + k] / d0;
    const float lb = (H[r + k + 1] - la * l10) / d1;
    H[r + k] = la;
    H[r + k + 1] = lb;
    lw[2 * x] = la;
    lw[2 * x + 1] = lb;
  }
  if (t == kN - 1) {
    const float lkk0 = p0 / d0, y0 = b[k] / lkk0;
    const float lkk1 = p1 / d1, y1 = (b[k + 1] - l10 * y0) / lkk1;
    sc[0] = lkk0;
    sc[1] = l10;
    sc[2] = lkk1;
    sc[3] = y0;
    sc[4] = y1;
  }
  step_sync<kN>();
  const int count = tri(n), base = tri(c) + c;
  const float2* l2 = reinterpret_cast<const float2*>(lw);
  for (int m = t; m < count; m += 2 * kN) {
    // two entries at once: both loads before both stores (the entries are
    // distinct, which the compiler cannot see)
    const int m2 = m + kN;
    const bool two = m2 < count;
    int a, bb, a2 = 0, b2 = 0;
    place(m, a, bb);
    if (two) place(m2, a2, b2);
    const int q = m + c * a + base, q2 = m2 + c * a2 + base;
    const float2 la = l2[a], lb = l2[bb];
    float v = H[q], v2 = 0.f;
    if (two) {
      const float2 la2 = l2[a2], lb2 = l2[b2];
      v2 = (H[q2] - la2.x * lb2.x) - la2.y * lb2.y;
    }
    v = (v - la.x * lb.x) - la.y * lb.y;
    H[q] = v;
    if (two) H[q2] = v2;
  }
  const float y0 = sc[3], y1 = sc[4];
  for (int x = t; x < n; x += kN) {
    const float2 l = l2[x];
    b[c + x] = (b[c + x] - l.x * y0) - l.y * y1;
  }
  if (t == kN - 1) {
    H[tri(k) + k] = sc[0];
    H[tri(k + 1) + k] = sc[1];
    H[tri(k + 1) + k + 1] = sc[2];
    b[k] = y0;
    b[k + 1] = y1;
  }
  step_sync<kN>();
}

// In-place right-looking Cholesky of H with the forward substitution of b
// (which becomes y, L y = b) riding along; subtracts S_ij -= L_ik L_jk for
// k < j <= i over k ascending, and b_i -= L_ik y_k likewise, as the plain
// version does. Two columns a step (`pair_step`), two syncs a step: one
// barrier a column. While more than kWarpFinish rows lie below a pair, the
// block takes the step under block barriers; then warp 0 finishes alone
// under __syncwarp, the other warps return, and an odd last column is
// warp 0's lane 0's. Starts after a block barrier; ends with warp 0
// synchronised and the factor and y in place for it (the caller's
// back_solve), the block not.
__device__ void factor(const Sys& s, float* b, int t) {
  float* H = s.H;
  const int nv = s.nv;
  int k = 0;
  for (; k + 1 < nv && nv - k - 2 > kWarpFinish; k += 2)
    pair_step<kThreads>(H, b, s.lw, nv, k, t);
  if (t >= 32) return;
  for (; k + 1 < nv; k += 2) pair_step<32>(H, b, s.lw, nv, k, t);
  if (k < nv && t == 0) {
    const float p = H[tri(k) + k];
    const float lkk = p / sqrtf(fmaxf(p, kEps));
    H[tri(k) + k] = lkk;
    b[k] = b[k] / lkk;
  }
  __syncwarp();
}

// Warp 0: solve L^T x = y in place, rows from the last. x_j (j = lane mod
// 32) is read and written by its lane alone; each x_i reaches the others
// by a shuffle.
__device__ void back_solve(const Sys& s, float* x, int lane) {
  const float* L = s.H;
  for (int i = s.nv - 1; i >= 0; --i) {
    const int owner = i & 31;
    float xi = 0.f;
    if (lane == owner) {
      xi = x[i] / L[tri(i) + i];
      x[i] = xi;
    }
    xi = __shfl_sync(kFull, xi, owner);
    const float* Li = L + tri(i);
    for (int j = lane; j < i; j += 32) x[j] = x[j] - Li[j] * xi;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks) newton_wide_kernel(
    const float* __restrict__ qM, const float* __restrict__ J,
    const float* __restrict__ aref, const float* __restrict__ R,
    const float* __restrict__ floss, const float* __restrict__ active,
    const float* __restrict__ warm, const float* __restrict__ qfs,
    const float* __restrict__ damph, float* __restrict__ qacc,
    float* __restrict__ qfrc, float* __restrict__ force,
    float* __restrict__ asmooth, float* __restrict__ qacc_euler,
    float* __restrict__ work, unsigned long long* __restrict__ cycles,
    int nv, int nefc, int nfr, int iterations, int ls_iterations) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int lane = t & 31;
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
  int origin;   // floats from an 8-byte boundary to base
  if constexpr (kStaged) {
    const int ld = row_ld(nv);
    float* M = smem + kScalars;
    for (int i = t; i < nv * nv; i += kThreads)
      M[(i / nv) * ld + i % nv] = gM[i];
    s.M = M;
    s.ldm = ld;
    base = M + nv * ld;
    origin = kScalars + nv * ld;
  } else {
    s.M = gM;
    s.ldm = nv;
    base = work + env * work_floats(nv, nefc);
    origin = 0;
  }
  s.J = J + env * nefc * nv;
  s.aref = aref + r0;
  s.R = R + r0;
  s.floss = floss + r0;
  s.active = active + r0;
  s.qfs = qfs + v0;
  s.damph = damph + v0;
  s.H = base;
  s.v = base + tri(nv);
  s.r = s.v + kNvVecs * nv;
  {
    const int o = tri(nv) + kNvVecs * nv +
                  (lw_in_jp(nv, nefc) ? kJp : kRowVecs) * nefc;
    s.lw = base + o + ((origin + o) & 1);
  }
  for (int i = t; i < nv; i += kThreads) {
    s.vec(kAs)[i] = s.qfs[i];
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

    // J p and qM p, then the line search: in each step every thread
    // evaluates its rows at alpha, and every warp sums them in warp 0's
    // order to the same next alpha. The terms go to two pairs of rows that
    // are dead here (the weights and forces, the lists), in turn, so a
    // step needs one barrier: a thread writes a pair only after the
    // barrier that every reader of its previous use had to reach first.
    float* mp = s.vec(kTmp);
    float* jp = s.row(kJp);
    for (int i = t; i < nv; i += kThreads)
      mp[i] = row_dot(s.M + i * s.ldm, p, nv);
    j_rows(s, p, jp, nullptr, false, t);
    __syncthreads();
    const float g0 = warp_sum(lane_dot(p, mda, nv, lane));
    const float pmp = warp_sum(lane_dot(p, mp, nv, lane));
    float alpha = 1.f;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float* tf = s.row(ls & 1 ? kListF : kF);
      float* tw = s.row(ls & 1 ? kListW : kW);
      for (int e = t; e < nefc; e += kThreads) {
        float f, w;
        const float jpe = jp[e];
        row_force(s, e, jar[e] + alpha * jpe, &f, &w);
        tf[e] = f * jpe;
        tw[e] = w * jpe * jpe;
      }
      __syncthreads();
      const float dphi = g0 + alpha * pmp - warp_sum(lane_sum(tf, nefc, lane));
      const float ddphi = pmp + warp_sum(lane_sum(tw, nefc, lane));
      alpha = fminf(fmaxf(alpha - dphi / fmaxf(ddphi, kEps), 0.f), 4.f);
    }
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
    p[i] = s.qfs[i] + q;
  }
  PHASE(kFinal);

  // 5. implicit-damping Euler solve
  fill_h(s, s.damph, t);
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

// the kernel for these sizes: working set in shared memory, or in the
// device-memory workspace
const void* kernel_for(int nv, int nefc) {
  return staged(nv, nefc) ? (const void*)newton_wide_kernel<true>
                          : (const void*)newton_wide_kernel<false>;
}

// The splits of an SM's 256 KB between shared memory and L1 that an H100
// offers, in KB of shared memory (CUDA C++ Programming Guide, compute
// capability 9.0). A carveout is a percentage of the largest; the runtime
// takes the smallest split at least that large.
constexpr int kSplitsKB[] = {0, 8, 16, 32, 64, 100, 132, 164, 196, 228};
constexpr int kSplits = sizeof(kSplitsKB) / sizeof(kSplitsKB[0]);
constexpr int kLargestKB = kSplitsKB[kSplits - 1];

// bytes of shared memory the runtime keeps for each block
int reserved_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  return bytes;
}

// the blocks per SM that shared memory alone allows at a split of `kb` KB
long smem_blocks(int nv, int nefc, long kb) {
  return kb * 1024 / ((long)smem_bytes(nv, nefc) + reserved_smem());
}

// The carveout a launch at these sizes asks for: the smallest split that
// holds as many blocks as the registers allow (kMinBlocks), or as shared
// memory allows at the largest split where that is fewer, so that the rest
// of the SM stays L1 for the passes over J. The NEWTON_WIDE_CARVEOUT build
// asks for that percentage instead (-1: no preference, the runtime's
// default), to time the kernel at another split.
int carveout(int nv, int nefc) {
#ifdef NEWTON_WIDE_CARVEOUT
  (void)nv;
  (void)nefc;
  return NEWTON_WIDE_CARVEOUT;
#else
  long blocks = smem_blocks(nv, nefc, kLargestKB);
  if (blocks > kMinBlocks) blocks = kMinBlocks;
  const long need = blocks * ((long)smem_bytes(nv, nefc) + reserved_smem());
  int i = 0;
  while (i < kSplits - 1 && kSplitsKB[i] * 1024L < need) ++i;
  // rounded down, so that the split taken is kSplitsKB[i] and no larger
  return (int)(kSplitsKB[i] * 100L / kLargestKB);
#endif
}

// the split, in KB of shared memory, that a carveout of `pct` selects
// (-1 where it has none: the runtime chooses)
int split_kb(int pct) {
  if (pct < 0) return -1;
  int i = 0;
  while (i < kSplits - 1 && kSplitsKB[i] * 100L < (long)pct * kLargestKB) ++i;
  return kSplitsKB[i];
}

// Set the attributes a launch at these sizes needs: its dynamic shared
// memory and its carveout.
cudaError_t configure(int nv, int nefc) {
  const void* fn = kernel_for(nv, nefc);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(nv, nefc));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        carveout(nv, nefc));
  return err;
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

// Blocks that fit on one SM at once at these sizes, with the attributes
// that a launch sets, or a negative CUDA error.
int newton_wide_occupancy(int nv, int nefc) {
  if (nv < 1 || nefc < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = configure(nv, nefc);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel_for(nv, nefc), kThreads, (int)smem_bytes(nv, nefc));
  return err == cudaSuccess ? blocks : -(int)err;
}

// What a launch at these sizes is set up with, read back from the runtime
// (cudaFuncGetAttributes of the instantiation launched) after setting it:
// out[0] the preferred carveout in percent of the largest split (-1: none),
// out[1] registers and out[2] bytes of local memory a thread, out[3] the
// split in KB of shared memory that out[0] selects (-1: the runtime's
// default), out[4] and out[5] the blocks per SM that shared memory alone
// allows at that split (-1 where the runtime chooses) and at the largest.
// Returns 0 or a CUDA error.
int newton_wide_config(int nv, int nefc, int* out) {
  if (nv < 1 || nefc < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure(nv, nefc);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, kernel_for(nv, nefc));
  if (err != cudaSuccess) return (int)err;
  const int kb = split_kb(attr.preferredShmemCarveout);
  out[0] = attr.preferredShmemCarveout;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = kb;
  out[4] = kb < 0 ? -1 : (int)smem_blocks(nv, nefc, kb);
  out[5] = (int)smem_blocks(nv, nefc, kLargestKB);
  return 0;
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
  cudaError_t err = configure(nv, nefc);
  if (err != cudaSuccess) return (int)err;
  auto kernel = in_smem ? newton_wide_kernel<true> : newton_wide_kernel<false>;
  kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)qM, (const float*)J, (const float*)aref,
      (const float*)R, (const float*)floss, (const float*)active,
      (const float*)warm, (const float*)qfrc_smooth, (const float*)damph,
      (float*)qacc, (float*)qfrc, (float*)force, (float*)asmooth,
      (float*)qacc_euler, (float*)work, (unsigned long long*)cycles, nv,
      nefc, n_friction, iterations, ls_iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"

// K3: one whole bounded Levenberg-Marquardt stage per lane, a team of
// threads per lane, and on request the fit's whole retry ladder in the
// same launch.
//
// Replaces npswf_tpu/fit/pallas_lm.py::_lm_kernel (wrappers _lm_call and
// lm_solve_pallas). Per lane, until it converges or spends its budget:
//   - the sin bound transform p = mid + half*sin(u);
//   - the spline model from the padded segment planes: the TPU kernel's
//     mod-SEG barrel shift becomes a direct load at segment slot
//     (fit_lo_bin + k - ceil(t + x0) + PAD) mod SEG, and the support gate
//     1 < x - t < ntime - 1 zeroes what lies outside;
//   - the weighted Jacobian columns of each fit bin, reduced into the
//     packed normal equations (A, g) and chi2;
//   - the MINPACK scaled-gradient test with the KKT active-bound mask;
//   - a Jacobi-scaled, Marquardt-damped Cholesky solve;
//   - accept (lambda / lambda_down) or reject (lambda * lambda_up), clipped,
//     with the normal equations of the current point cached across
//     rejected steps, and the relative-chi2 ftol test;
//   - per-lane budgets: a lane that spends its budget freezes unconverged.
// Inactive lanes return u0, chi2 = 0, conv = false, n_iter = 0, edm = inf
// and lambda = lambda0, as the XLA while-loop does.
//
// The ladder (prm.rungs > 0; fit/lm.py::fit_waveforms, whose host ladder
// over lm_solve_plain is its plain version). After stage 1 a lane that is
// active and did not converge climbs the rungs in the team that ran its
// stage 1, each rung the same stage loop from a new start point:
//   - rung 0, the stage-2 restart: from u0 with lam2 (lambda_init x 10) and
//     the lane's stage-2 budget (budget2, at most max_iter2 iterations);
//   - rung r > 0, the (r-1)-th pull-back m: from u1, the stage-1 end point,
//     with each component that has |sin u1| > 0.95 and its parameter
//     unmasked moved to asin(m * sign(sin u1)), with lam3 (lambda_init)
//     and the stage-2 budget; where it converges its point and chi2 replace
//     the stage-2 ones and the lane counts as converged, and its
//     iterations add to the rungs' in any case.
// The lane leaves the ladder at its first converged rung (the host's
// ladder stops where no lane is left to retry: the same per lane). Stage 1
// and the rungs are one loop around one stage runner (TeamLane::run), so
// the kernel holds the registers of one stage. Between stages u0, u1 and
// the rungs' best point wait in shared memory beside the team's other
// arrays, each thread reading and writing only its own component
// (M <= kTeam), and every thread keeps the rungs' chi2, flag and
// iterations; the planes, y, w and the bounds stay in shared memory from
// stage 1, so a rung reads from global memory only the lane's stage-2
// budget and, for a pull-back, its value and the lane's parameter mask.
// Lanes that enter no rung write the zeros the host ladder gives them.
// Thread 0 of each lane adds one to tally[r] for every rung r the lane
// enters, so the host reads the lanes of each rung in one read a batch
// instead of a sync a rung. A retry thus needs no launch of its own, no
// gather of its lanes and no host test between the rungs. What it costs: a
// lane scheduled late in the launch that climbs every rung ends the launch
// (up to 190 iterations in a row at the narrow budgets, 380 at the wide
// ones).
//
// What bounds it on the card: latency, not bytes. A lane's iterations run
// in sequence, each over 90 fit bins, M(M+1)/2 + M + 1 sums (21 at P = 2,
// 351 at P = 12) and a Cholesky solve; a lane that climbs the ladder runs
// up to stage 1's and three rungs' budgets in a row while most lanes
// finish after stage 1. What the design does about it:
//   - a team, one warp (a cooperative-groups tile of 32 threads, one
//     block), works each lane, so the lanes spread over the SMs and each
//     iteration's work is split 32 ways;
//   - the system evaluation runs in two phases: (a) thread t takes fit bins
//     t, t + 32, ... (four at a time in registers for P <= 4) and writes
//     each bin's columns and residual to shared memory (bin_columns, the
//     per-bin function K6 runs too); (b) each sum of A, g and chi2 belongs
//     to one thread, which adds it up over the bins in bin order from zero
//     -- the order of K6 and of the plain version, so the kernel stays
//     bit-equal to them (no shuffle trees, no split partial sums);
//   - the lane's coefficient planes, y and w are staged in shared memory
//     once, and every iteration reads them there;
//   - A, g, chi2, u, sin(u) and dp/du of the current point and of the
//     trial, the damped matrix and its Cholesky factor live in shared
//     memory, so P = 12 keeps no M(M+1)/2 arrays in registers;
//   - the linear algebra is split over the team without changing any
//     sum's order: the gcrit terms, the Jacobi scales and the damped matrix
//     entry by entry; the Cholesky factor row by row, thread c taking entry
//     (a, c) with the subtractions of the outer-product form in its order
//     (one tile.sync a row); the forward solve one row a thread, each y_k
//     passed through shared memory; the back solve by every thread in
//     registers. Each thread loads its operands before it stores, so the
//     loads overlap, and no value crosses the team by shuffle;
//   - the gcrit maximum and the per-lane decisions (accept, lambda, ftol,
//     budget) are computed by every thread from shared memory, so the
//     loop's exit is uniform across the team with no broadcast.
// The team synchronises only with tile.sync(). Compiled with -fmad=false
// so each product and sum rounds as in the plain PyTorch version.
//
// Every pulse count from 1 to kMaxP has its own instantiation. They are
// compiled in several translation units, lm_p*.cu, each a group of widths
// (NPSWF_LM_WIDTH), so that the build compiles them in parallel; lm.cu
// dispatches to them, and above kMaxP to lm_wide.cu (P at run time, a
// thread owning every 32nd row, up to what a block's shared memory holds).
#pragma once

#include <cooperative_groups.h>

#include "spline_system.cuh"

namespace cg = cooperative_groups;

namespace npswf {

struct LMParams {
  double lam_up, lam_down, lam_min, lam_max, ftol, gtol, eps, gate_lo,
      gate_hi, sat, chol_eps;
  // the ladder: the rungs' damping (stage 2, the pull-backs)
  double lam2, lam3;
  // rungs: 0 = stage 1 alone; else the stage-2 restart and rungs - 1
  // pull-backs, max_iter2 iterations at most each
  int fit_lo, nk, n, max_iter, max_iter2, rungs;
};

// A launch's arrays: stage 1's inputs and outputs, then the ladder's
// (budget2, the rungs - 1 pull-back values in order and the rungs'
// outputs, null when rungs = 0).
template <typename T>
struct LMArgs {
  const T *coeffs, *x0, *yt, *wt, *u0, *lo, *hi, *pseed;
  const uint8_t *pmask, *active;
  const int* budget;
  const T* lam0;
  const int* budget2;
  const double* pullback;
  T *u, *chi2;
  uint8_t* conv;
  int* n_iter;
  T *edm, *lam;
  T *u2, *chi2_2;
  uint8_t* conv2;
  int *it2, *tally;
};

// Where a stage ends: its point is in slot cur of the team's uv.
template <typename T>
struct StageEnd {
  T chi2, lam, edm;
  int n_iter, cur;
  bool conv;
};

constexpr int kTeam = 32;  // threads of a lane's team: one warp, one block

// A team's shared memory: the block's dynamic shared memory. Slots 0 and 1
// of sys, uv, sns and dps hold the current point and the trial, in either
// order.
template <typename T, int P>
struct TeamMem {
  static constexpr int M = 1 + 2 * P;
  static constexpr int MT = M * (M + 1) / 2;
  static constexpr int NE = MT + M + 1;  // packed A, g, chi2
  // offsets, in values, of the fixed-size arrays after the per-bin ones
  static constexpr int kUv = 2 * NE, kSns = kUv + 2 * M, kDps = kSns + 2 * M,
                       kS = kDps + 2 * M, kHalf = kS + MT, kMid = kHalf + M,
                       kSeed = kMid + M, kPp = kSeed + M, kScale = kPp + M,
                       kB = kScale + M, kGv = kB + M, kDg = kGv + M,
                       kYv = kDg + M, kUu = kYv + M,
                       kActp = kUu + P, kU0 = kActp + P, kU1 = kU0 + M,
                       kU2 = kU1 + M, kEnd = kU2 + M;

  T* at;   // the per-bin arrays
  T* fx;   // the fixed-size arrays
  int nk;

  static size_t bytes(int nk) {
    const size_t nt = (size_t)4 * kSeg + (size_t)nk * (M + 3) + kEnd;
    return (nt * sizeof(T) + P * sizeof(int) + 2 * M + 15) / 16 * 16;
  }

  __device__ TeamMem(unsigned char* p, int nk_)
      : at(reinterpret_cast<T*>(p)),
        fx(at + 4 * kSeg + (size_t)nk_ * (M + 3)),
        nk(nk_) {}

  __device__ T* planes() const { return at; }            // [4, SEG]
  __device__ T* y() const { return at + 4 * kSeg; }      // [nk]
  __device__ T* w() const { return y() + nk; }           // [nk]
  __device__ T* cs() const { return w() + nk; }          // [nk, M + 1]: columns, residual
  __device__ T* sys() const { return fx; }               // [2, NE] A, g, chi2
  __device__ T* uv() const { return fx + kUv; }          // [2, M] u
  __device__ T* sns() const { return fx + kSns; }        // [2, M] sin(u)
  __device__ T* dps() const { return fx + kDps; }        // [2, M] dp/du
  __device__ T* S() const { return fx + kS; }            // [MT] damped matrix, then L off the diagonal
  __device__ T* half() const { return fx + kHalf; }      // [M]
  __device__ T* mid() const { return fx + kMid; }        // [M]
  __device__ T* seed() const { return fx + kSeed; }      // [M]
  __device__ T* pp() const { return fx + kPp; }          // [M] physical parameters
  __device__ T* scale() const { return fx + kScale; }    // [M] Jacobi scales
  __device__ T* b() const { return fx + kB; }            // [M] scaled gradient
  __device__ T* gv() const { return fx + kGv; }          // [M] gcrit terms
  __device__ T* dg() const { return fx + kDg; }          // [M] the factor's diagonal
  __device__ T* yv() const { return fx + kYv; }          // [M] forward solve
  __device__ T* uu() const { return fx + kUu; }          // [P] spline fractions
  __device__ T* actp() const { return fx + kActp; }      // [P] pulse masks
  __device__ T* u0() const { return fx + kU0; }          // [M] the start point
  __device__ T* u1() const { return fx + kU1; }          // [M] stage 1's end
  __device__ T* u2() const { return fx + kU2; }          // [M] the rungs' best end
  __device__ int* base() const { return reinterpret_cast<int*>(fx + kEnd); }  // [P]
  __device__ uint8_t* ok() const { return reinterpret_cast<uint8_t*>(base() + P); }  // [M]
  __device__ uint8_t* dead() const { return ok() + M; }  // [M]
};

// The sums a thread owns: entries tr, tr + kTeam, ... of the NE sums, each
// the product of columns ci and cj of a bin row (column M is the residual).
template <int M>
struct Owned {
  static constexpr int MT = M * (M + 1) / 2;
  static constexpr int NE = MT + M + 1;
  static constexpr int N = (NE + kTeam - 1) / kTeam;
  int ci[N], cj[N];

  __device__ explicit Owned(int tr) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      int p = tr + e * kTeam, i = 0;
      if (p < MT) {
        while (p >= M - i) { p -= M - i; ++i; }
        ci[e] = i;
        cj[e] = i + p;
      } else {
        ci[e] = p < NE ? p - MT : M;  // g: (i, r); chi2: (r, r)
        cj[e] = M;
      }
    }
  }
};

// One lane's work, done by the team ``tile``; tr is the thread's rank in it.
template <typename T, int P, typename Tile>
struct TeamLane {
  static constexpr int M = 1 + 2 * P;
  static constexpr int MT = M * (M + 1) / 2;
  static constexpr int NE = MT + M + 1;
  static_assert(M <= kTeam, "the solves hold one row a thread");

  Tile tile;
  TeamMem<T, P> s;
  Owned<M> own;
  LMParams prm;
  int tr;
  T x0;

  // A, g, chi2 at the point in slot ``slot``: (a) the transform, then
  // each thread's fit bins, BATCH at a time in registers (a bin past the
  // last is computed as the last and not stored, so the batch has no
  // branch and its bins overlap), into shared memory; (b) each thread's
  // sums in bin order.
  __device__ __forceinline__ void system(int slot) {
    const T* u = s.uv() + slot * M;
    T* sn = s.sns() + slot * M;
    T* dp = s.dps() + slot * M;
    for (int i = tr; i < M; i += kTeam) {
      sn[i] = sin(u[i]);
      transform_one(sn[i], cos(u[i]), s.mid()[i], s.half()[i], s.seed()[i],
                    s.ok()[i] != 0, s.pp()[i], dp[i]);
      if (i & 1) pulse_slot(s.pp()[i], x0, prm.fit_lo, s.uu()[i / 2], s.base()[i / 2]);
    }
    tile.sync();
    const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
    constexpr int BATCH = P <= 4 ? 4 : 1;
    for (int k0 = tr; k0 < prm.nk; k0 += BATCH * kTeam) {
      T col[BATCH][M + 1];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int k = min(k0 + j * kTeam, prm.nk - 1);
        bin_columns<T, P>(k, prm.fit_lo, gate_lo, gate_hi, s.w()[k], s.y()[k],
                          s.planes(), s.pp(), dp, s.uu(), s.base(), s.actp(),
                          col[j], col[j][M]);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int k = k0 + j * kTeam;
        if (k < prm.nk) {
          T* c = s.cs() + (size_t)k * (M + 1);
#pragma unroll
          for (int i = 0; i <= M; ++i) c[i] = col[j][i];
        }
      }
    }
    tile.sync();
    constexpr int NO = Owned<M>::N;
    T acc[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[e] = T(0);
#pragma unroll 6
    for (int k = 0; k < prm.nk; ++k) {
      const T* c = s.cs() + (size_t)k * (M + 1);
#pragma unroll
      for (int e = 0; e < NO; ++e) acc[e] = acc[e] + c[own.ci[e]] * c[own.cj[e]];
    }
    T* out = s.sys() + slot * NE;
#pragma unroll
    for (int e = 0; e < NO; ++e)
      if (tr + e * kTeam < NE) out[tr + e * kTeam] = acc[e];
    tile.sync();
  }

  // The MINPACK scaled gradient over the KKT-free components at the point
  // in slot ``slot``, and the Jacobi scales of its step: component i by
  // thread i mod kTeam, then the max over the components in order by every
  // thread.
  __device__ __forceinline__ T gcrit(int slot) {
    const T* A = s.sys() + slot * NE;
    const T* g = A + MT;
    const T* sn = s.sns() + slot * M;
    const T* dp = s.dps() + slot * M;
    const T sqc = sqrt(nan_max(A[MT + M], T(prm.eps)));
    const T sat = T(prm.sat);
    for (int i = tr; i < M; i += kTeam) {
      const T di = A[tri<M>(i, i)];
      const bool dead = di <= T(1e-30);
      s.dead()[i] = dead;
      s.scale()[i] = di > T(1e-30) ? sqrt(di) : T(1);  // NaN: neither dead nor scaled
      const T push = g[i] * dp[i];
      const bool kkt = (sn[i] > sat && push > T(0)) || (sn[i] < -sat && push < T(0));
      const T denom = sqrt(dead ? T(1) : di) * sqc;
      s.gv()[i] = ((dead || kkt) ? T(0) : fabs(g[i])) / denom;
    }
    tile.sync();
    T out = s.gv()[0];
    for (int i = 1; i < M; ++i) out = nan_max(out, s.gv()[i]);
    return out;
  }

  // The Cholesky factor L of the damped matrix in S, row by row: thread c
  // takes entry (a, c) of row a, S(a, c) - L(0, a) L(0, c) - L(1, a) L(1, c)
  // - ..., the subtractions the outer-product form makes, in its order, and
  // every thread the diagonal's, so that each has d = sqrt(max(diag, eps))
  // with no broadcast. L(a, c) = entry / d overwrites S(a, c); L(a, a) goes
  // to dg, since in place it could change under a thread still reading it.
  __device__ __forceinline__ void factor(T* S, T* dg) {
    const int c = tr;
    const bool mine = c < M;
    const T ceps = T(prm.chol_eps);
#pragma unroll
    for (int a = 0; a < M; ++a) {
      const bool off = mine && c > a;
      T vd = S[tri<M>(a, a)];
      T v = off ? S[tri<M>(a, c)] : T(0);
#pragma unroll
      for (int j = 0; j < a; ++j) {
        const T la = S[tri<M>(j, a)];
        vd = vd - la * la;
        if (off) v = v - la * S[tri<M>(j, c)];
      }
      const T d = sqrt(nan_max(vd, ceps));
      if (off) S[tri<M>(a, c)] = v / d;
      if (c == a) dg[a] = vd / d;
      tile.sync();
    }
  }

  // The two triangular solves with the factor, L y = b then L^T d = y;
  // returns d_tr. Each sum runs in the plain version's order. L y = b: thread
  // i holds row i and takes its terms k = 0, 1, ... as each y_k arrives
  // through shared memory. L^T d = y: every thread runs it whole, d in
  // registers, so that d_i sums k = i + 1, ..., M - 1 with no broadcast.
  __device__ __forceinline__ T solve(const T* S, const T* dg) {
    T* yv = s.yv();
    const int i = tr;
    T acc = i < M ? s.b()[i] : T(0);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (i == k) yv[k] = acc / dg[k];
      tile.sync();
      if (i > k && i < M) acc = acc - S[tri<M>(k, i)] * yv[k];
    }
    T dv[M], d = T(0);
#pragma unroll
    for (int r = M - 1; r >= 0; --r) {
      T a = yv[r];
#pragma unroll
      for (int k = r + 1; k < M; ++k) a = a - S[tri<M>(r, k)] * dv[k];
      dv[r] = a / dg[r];
      if (i == r) d = dv[r];
    }
    return d;
  }

  // Jacobi-scaled damped step from the point in slot ``slot`` (scales from
  // gcrit): solve (D^-1 A D^-1 + lam I) (D delta) = D^-1 g by an
  // outer-product Cholesky (computed row by row) on the packed matrix, and
  // write the trial point u + delta into the other slot. Each thread loads
  // all it needs before it stores, so its entries' loads overlap.
  __device__ __forceinline__ void step(int slot, T lam) {
    constexpr int NO = Owned<M>::N;
    const T* A = s.sys() + slot * NE;
    const T* g = A + MT;
    const T* scale = s.scale();
    const uint8_t* dead = s.dead();
    T* S = s.S();
    T v[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) {
      const int p = tr + e * kTeam, i = own.ci[e], j = own.cj[e];
      if (p < MT)
        v[e] = i == j ? T(1) + lam
                      : ((dead[i] || dead[j]) ? T(0) : A[p] / (scale[i] * scale[j]));
    }
#pragma unroll
    for (int e = 0; e < NO; ++e)
      if (tr + e * kTeam < MT) S[tr + e * kTeam] = v[e];
    for (int i = tr; i < M; i += kTeam) s.b()[i] = dead[i] ? T(0) : g[i] / scale[i];
    tile.sync();
    factor(S, s.dg());
    const T d = solve(S, s.dg());
    if (tr < M) {
      const T* u = s.uv() + slot * M;
      s.uv()[(1 - slot) * M + tr] = u[tr] + (dead[tr] ? T(0) : d / scale[tr]);
    }
    tile.sync();
  }

  // One LM stage from the point in slot 0 of uv, with damping lam and the
  // lane's budget bud, at most max_iter iterations: the loop of the plain
  // version. Every thread runs the decisions, so the result is uniform.
  __device__ __forceinline__ StageEnd<T> run(T lam, int bud, int max_iter) {
    // slot cur of sys and uv holds the current point, 1 - cur the trial
    int cur = 0;
    system(0);
    T chi2 = s.sys()[MT + M];
    const T ftol = T(prm.ftol), gtol = T(prm.gtol);
    const T lam_up = T(prm.lam_up), lam_down = T(prm.lam_down);
    const T lam_min = T(prm.lam_min), lam_max = T(prm.lam_max);
    bool done = bud <= 0, conv = false;
    int n_iter = 0;
    T edm = T(INFINITY);
    for (int it = 0; it < max_iter && !done; ++it) {
      const T gc = gcrit(cur);
      const bool conv_g = gc < gtol;
      step(cur, lam);
      system(1 - cur);
      const T chi2_try = s.sys()[(1 - cur) * NE + MT + M];
      const bool good = isfinite(chi2_try) && chi2_try < chi2;
      const bool accept = good && !conv_g;
      const T chi2_new = accept ? chi2_try : chi2;
      if (accept) cur = 1 - cur;  // the trial becomes the current point
      const T lam_new = clip(accept ? lam / lam_down : lam * lam_up, lam_min, lam_max);
      const T rel_impr = (chi2 - chi2_new) / nan_max(chi2, T(1));
      const bool conv_f = accept && rel_impr < ftol;
      const bool conv_now = conv_g || conv_f;
      n_iter += 1;
      done = conv_now || n_iter >= bud;
      conv = conv || conv_now;
      chi2 = chi2_new;
      lam = lam_new;
      edm = gc;
    }
    return {chi2, lam, edm, n_iter, cur, conv};
  }
};

// Teams an SM must hold at once at P <= 2, where most lanes are: 28 in
// fp32 (72 registers a thread, as the single-stage kernel took), 21 in
// fp64 (the compiler takes 80). Unbounded, the ladder's loop takes 96 and
// 110 registers, and the SM holds a quarter fewer lanes: on an H100 the
// P = 2 ladder over 69,120 lanes took 3.0 ms fp32 and 4.3 ms fp64 so,
// against 2.8 and 4.1 bounded, a few spilled bytes included. Wider lanes
// take what the compiler gives them.
template <typename T, int P>
constexpr int kMinTeams = P > 2 ? 1 : (sizeof(T) == 4 ? 28 : 21);

template <typename T, int P>
__global__ void __launch_bounds__(kTeam, (kMinTeams<T, P>))
lm_kernel(const LMArgs<T> a, const LMParams prm) {
  constexpr int M = 1 + 2 * P;
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = cg::tiled_partition<kTeam>(cg::this_thread_block());
  const int tr = tile.thread_rank();
  const int lane = blockIdx.x;
  const size_t row = (size_t)lane * M;
  // thread tr < M handles component tr of the lane's vectors (M <= kTeam)
  const bool comp = tr < M;
  const bool ladder = prm.rungs > 0;
  if (!a.active[lane]) {
    if (comp) a.u[row + tr] = a.u0[row + tr];
    if (tr == 0) {
      a.chi2[lane] = T(0);
      a.conv[lane] = 0;
      a.n_iter[lane] = 0;
      a.edm[lane] = T(INFINITY);
      a.lam[lane] = a.lam0[lane];
    }
    if (ladder) {
      if (comp) a.u2[row + tr] = T(0);
      if (tr == 0) {
        a.chi2_2[lane] = T(0);
        a.conv2[lane] = 0;
        a.it2[lane] = 0;
      }
    }
    return;
  }
  const TeamMem<T, P> s(smem, prm.nk);
  const T* coef = a.coeffs + (size_t)lane * 4 * kSeg;
  for (int i = tr; i < 4 * kSeg; i += kTeam) s.planes()[i] = coef[i];
  for (int k = tr; k < prm.nk; k += kTeam) {
    s.y()[k] = a.yt[(size_t)k * prm.n + lane];
    s.w()[k] = a.wt[(size_t)k * prm.n + lane];
  }
  if (comp) {
    const T l = a.lo[row + tr], h = a.hi[row + tr];
    s.half()[tr] = T(0.5) * (h - l);
    s.mid()[tr] = T(0.5) * (h + l);
    s.seed()[tr] = a.pseed[row + tr];
    s.ok()[tr] = a.pmask[row + tr] != 0 && s.half()[tr] > T(0);
    s.u0()[tr] = s.uv()[tr] = a.u0[row + tr];
    s.u2()[tr] = T(0);
  }
  for (int q = tr; q < P; q += kTeam) s.actp()[q] = a.pmask[row + 2 + 2 * q] ? T(1) : T(0);
  tile.sync();

  using Lane = TeamLane<T, P, decltype(tile)>;
  Lane L{tile, s, Owned<M>(tr), prm, tr, a.x0[lane]};
  // r = -1 is stage 1, r >= 0 the rungs; between stages each thread reads
  // and writes only its own component of uv, u0, u1 and u2, so the next
  // stage's start point needs one tile.sync
  T chi2_2 = T(0);
  bool conv2 = false;
  int it2 = 0;
  for (int r = -1; r < prm.rungs; ++r) {
    T lam;
    int bud, max_iter;
    if (r < 0) {
      lam = a.lam0[lane];
      bud = a.budget[lane];
      max_iter = prm.max_iter;
    } else {
      lam = T(r == 0 ? prm.lam2 : prm.lam3);
      bud = a.budget2[lane];
      max_iter = prm.max_iter2;
      if (tr == 0) atomicAdd(a.tally + r, 1);
      if (comp) {
        T start = s.u0()[tr];
        if (r > 0) {
          // the host's pull-back: pullback x sign(sin u1) in T, then asin
          const T u1 = s.u1()[tr];
          const T sn = sin(u1);
          const T m = T(a.pullback[r - 1]) * (sn > T(0) ? T(1) : T(-1));
          start = (fabs(sn) > T(0.95) && a.pmask[row + tr]) ? asin(m) : u1;
        }
        s.uv()[tr] = start;
      }
      tile.sync();
    }
    const StageEnd<T> e = L.run(lam, bud, max_iter);
    const T u_end = comp ? s.uv()[e.cur * M + tr] : T(0);
    if (r < 0) {
      if (comp) {
        a.u[row + tr] = u_end;
        s.u1()[tr] = u_end;
      }
      if (tr == 0) {
        a.chi2[lane] = e.chi2;
        a.conv[lane] = e.conv ? 1 : 0;
        a.n_iter[lane] = e.n_iter;
        a.edm[lane] = e.edm;
        a.lam[lane] = e.lam;
      }
      if (!ladder) return;
      if (e.conv) break;
    } else {
      if (r == 0 || e.conv) {
        if (comp) s.u2()[tr] = u_end;
        chi2_2 = e.chi2;
        conv2 = e.conv;
      }
      it2 += e.n_iter;
      if (conv2) break;
    }
  }
  if (comp) a.u2[row + tr] = s.u2()[tr];
  if (tr == 0) {
    a.chi2_2[lane] = chi2_2;
    a.conv2[lane] = conv2 ? 1 : 0;
    a.it2[lane] = it2;
  }
}

// Launch one block a lane with the team's shared memory; above 48 KB a
// block the kernel's limit is raised (allow_smem), and a launch the card
// cannot give its shared memory fails (no fallback). in: coeffs, x0, yt,
// wt, u0, lo, hi, pseed, pmask, active, budget, lam0, budget2, pullback;
// out: u, chi2, conv, n_iter, edm, lam, u2, chi2_2, conv2, it2, tally (the
// last five, budget2 and pullback read only where prm.rungs > 0).
template <typename T, int P>
cudaError_t launch(const void* const* in, void* const* out,
                   const LMParams& prm, cudaStream_t st) {
  const size_t smem = TeamMem<T, P>::bytes(prm.nk);
  const cudaError_t e = allow_smem(lm_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  const LMArgs<T> a{
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const uint8_t*)in[8], (const uint8_t*)in[9], (const int*)in[10],
      (const T*)in[11], (const int*)in[12], (const double*)in[13],
      (T*)out[0], (T*)out[1], (uint8_t*)out[2], (int*)out[3], (T*)out[4],
      (T*)out[5], (T*)out[6], (T*)out[7], (uint8_t*)out[8], (int*)out[9],
      (int*)out[10]};
  lm_kernel<T, P><<<prm.n, kTeam, smem, st>>>(a, prm);
  return cudaGetLastError();
}

// Every pulse count from 1 to kMaxP, one instantiation each (the team's
// solves hold one row of the M x M system a thread: M <= kTeam); wider
// widths run lm_wide.cu's kernel, P at run time.
constexpr int kMaxP = 15;
static_assert(1 + 2 * kMaxP <= kTeam, "the solves hold one row a thread");

}  // namespace npswf

// The launches of width P at both types: defined where a lm_p*.cu
// instantiates them, declared (not instantiated) in lm.cu.
#define NPSWF_LM_WIDTH(EXT, P)                                              \
  EXT template cudaError_t npswf::launch<float, P>(                         \
      const void* const*, void* const*, const npswf::LMParams&, cudaStream_t); \
  EXT template cudaError_t npswf::launch<double, P>(                        \
      const void* const*, void* const*, const npswf::LMParams&, cudaStream_t);

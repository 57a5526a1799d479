// K3 at the wide widths: P > kMaxP (16 and up) with P taken at run time.
//
// The same LM stage as lm.cuh, with every sum in the plain version's
// order, so the kernel is bit-equal to lm_solve_plain. A lane is one block
// of 128 threads (M = 1 + 2P <= 64; a team of 64 timed slower with
// lm_split.py) or 256 (wider).
//
// What bounds it on the card: latency, not bytes or operations. A lane's
// iterations run in sequence, and each holds two chains that no split over
// threads shortens: the factor's M steps, each a square root and divisions
// that the next step needs, and the back solve, whose ascending sums chain
// M^2 / 2 subtractions one after another (each row's first term is the
// unknown the row before it has just found). Around them are the parallel
// parts: MT + M + 1 Gram sums of K products (110k at P = 24), the scaling,
// the trailing updates. The unit's first design (one warp a lane, every
// Gram entry with its own owner reading two shared values a product, a
// left-looking factor with a barrier a row, the back solve on one thread
// with its products on the chain) spent most of an iteration in the Gram
// sums and the factor (lm_split.py). What this design does:
//   - several warps a lane, and so few registers (kRegs32) and so little
//     shared memory (kLaneBytes) that eight lanes share an SM in fp32 to
//     M = 49: one lane's chains wait while the others' run;
//   - the Gram sums as owner blocks (K6's gram_reduce): a thread owns the
//     R x R entries (i0 + a, j0 + b) of the upper triangle of the Gram
//     matrix of the bin rows [cols | r], reads 2R values a bin (two 16-byte
//     loads in fp32) for R^2 products, and keeps the sums in registers over
//     a chunk's bins, each added in bin order from zero; between chunks they
//     wait in their slots of the system. Rows are padded to a multiple of R
//     with zero columns, whose products are never stored;
//   - a right-looking factor in panels of kPanel rows, two barriers a
//     panel: warp 0 factors the panel with no barrier inside it (every
//     lane factors the panel's diagonal block alike, then each lane takes
//     its columns of the panel rows in registers), and the whole team gives
//     each trailing entry (a, c) the panel's terms L(j, a) L(j, c) in
//     ascending j from a grid of owners (a mod TR, c mod TC). Row offsets
//     come from a closed form once a row, not in the inner loop. The
//     forward solve rides the panels: the block's rows take their y in the
//     block, and each column's running sum its panel terms in order;
//   - a back solve with its products off the chain: warp 1 forms
//     L(q, k) x(k) for q < k - 1 in place once x(k) is known, and thread 0
//     of warp 0 only subtracts, k = r + 1, ..., M - 1 in turn (the first
//     product, with the x it has just made, it forms itself); the two
//     warps meet at a named barrier once a row;
//   - the gcrit max as a shuffle tree of nan_max in every warp: exact in
//     any order, NaN propagating as torch.amax does.
// The damped matrix and its factor live in the trial point's slot of the
// system, which step() overwrites anyway and system() rewrites after it;
// the back solve's products overwrite the factor there. So the only limit
// is the block's shared memory (wide_chunk): at K = 90 fit bins on a card
// with 227 KB a block, 77 pulses in fp64 and 112 in fp32, the widest with
// chunks of 8 bins.
//
// Compiled with -fmad=false, as the rest.
#include "lm.cuh"

namespace npswf {

constexpr int kGramR = 4;          // owner blocks of the Gram sums: R x R
constexpr int kTc = 8;             // columns of the factor's owner grid
constexpr int kPanel = 3;          // rows of a panel of the factor
constexpr int kTeamSmall = 128;    // threads of a lane to M = kTeamSmallM
constexpr int kTeamSmallM = 64;
constexpr int kTeamLarge = 256;    // threads of a lane above it
constexpr int kMinChunk = 8;       // fewest bins a chunk stages
constexpr int kChunkFloor = 32;    // bins a chunk stages where it can
constexpr int kLaneBytes = 28160;  // a lane's shared memory for 8 an SM (228 KB, 1 KB a block kept)
constexpr int kRegs32 = 64;        // registers a thread, fp32 (8 lanes an SM)
constexpr int kRegs64 = 96;        // registers a thread, fp64


// blocks an SM holds by registers at NT threads of the type's budget
template <typename T, int NT>
constexpr int kWideMinBlocks = 65536 / (NT * (sizeof(T) == 4 ? kRegs32 : kRegs64));

// offset of row a in the packed upper triangle: (a, c) at row_off(a) + c
__host__ __device__ inline int row_off(int M, int a) {
  return a * (2 * M - a - 1) / 2;
}

// shared-memory offsets, in values, of a wide lane's arrays
struct WideLayout {
  int P, M, MT, NE, C, ld, nb, kc;
  int y, w, cs, sys, uv, sns, dps, half, mid, seed, pp, scale, gv, dg, yv, uu,
      actp, end;

  __host__ __device__ WideLayout(int p, int nk, int kc_) : P(p), kc(kc_) {
    M = 1 + 2 * P;
    MT = M * (M + 1) / 2;
    NE = MT + M + 1;
    C = M + 1;
    nb = (C + kGramR - 1) / kGramR;
    ld = nb * kGramR;
    y = 4 * kSeg;
    w = y + nk;
    cs = (w + nk + 3) / 4 * 4;  // 16-byte aligned rows
    sys = cs + kc * ld;
    uv = sys + 2 * NE;
    sns = uv + 2 * M;
    dps = sns + 2 * M;
    half = dps + 2 * M;
    mid = half + M;
    seed = mid + M;
    pp = seed + M;
    scale = pp + M;
    gv = scale + M;
    dg = gv + M;
    yv = dg + M;
    uu = yv + M;
    actp = uu + P;
    end = actp + P;
  }

  // values, then base [P] ints, then ok and dead [M] bytes each
  __host__ __device__ size_t bytes(size_t tsize) const {
    return ((size_t)end * tsize + (size_t)P * sizeof(int) + 2 * (size_t)M +
            15) / 16 * 16;
  }
};

// x[0..3] = p[0..3], p 16-byte aligned: one load in fp32, two in fp64
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    const double2 q0 = reinterpret_cast<const double2*>(p)[0];
    const double2 q1 = reinterpret_cast<const double2*>(p)[1];
    x[0] = q0.x; x[1] = q0.y; x[2] = q1.x; x[3] = q1.y;
  }
}

// warps 0 and 1 of the block meet (barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void pair_sync() {
  __syncwarp();
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

template <typename T>
struct WideLane {
  WideLayout L;
  T* v;          // the block's values
  int* base;     // [P]
  uint8_t* ok;   // [M]
  uint8_t* dead; // [M]
  LMParams prm;
  int tid, nt;   // the thread's rank and the team's size
  T x0;

  __device__ T* sys(int slot) const { return v + L.sys + slot * L.NE; }
  __device__ int roff(int a) const { return row_off(L.M, a); }

  // the sin transform of the point in slot ``slot``, each time component
  // with its pulse's fraction and slot
  __device__ void transform(int slot) {
    const int M = L.M;
    const T* u = v + L.uv + slot * M;
    T* sn = v + L.sns + slot * M;
    T* dp = v + L.dps + slot * M;
    for (int i = tid; i < M; i += nt) {
      sn[i] = sin(u[i]);
      transform_one(sn[i], cos(u[i]), v[L.mid + i], v[L.half + i],
                    v[L.seed + i], ok[i] != 0, v[L.pp + i], dp[i]);
      if (i & 1) pulse_slot(v[L.pp + i], x0, prm.fit_lo, v[L.uu + i / 2], base[i / 2]);
    }
    __syncthreads();
  }

  // bins k0 .. k0 + nc - 1, one a thread, to rows of ld values
  __device__ void stage(int slot, int k0, int nc) {
    const T* dp = v + L.dps + slot * L.M;
    const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
    for (int kk = tid; kk < nc; kk += nt) {
      const int k = k0 + kk;
      T* c = v + L.cs + (size_t)kk * L.ld;
      bin_columns<T, 0>(k, prm.fit_lo, gate_lo, gate_hi, v[L.w + k],
                        v[L.y + k], v, v + L.pp, dp, v + L.uu, base,
                        v + L.actp, c, c[L.M], L.P);
    }
    __syncthreads();
  }

  // Each owner block's sums over the chunk's nc bins in order, from zero
  // in the first chunk and from their slots after it. Block e of the
  // row-major upper triangle of nb x nb blocks goes to thread e mod nt, so
  // a warp's threads read neighbouring blocks of one bin row.
  __device__ void gram(int slot, int k0, int nc) {
    constexpr int R = kGramR;
    const int M = L.M, nb = L.nb, NB = nb * (nb + 1) / 2;
    T* out = sys(slot);
    for (int e = tid; e < NB; e += nt) {
      int bi = 0, off = e;
      while (off >= nb - bi) { off -= nb - bi; ++bi; }
      const int i0 = bi * R, j0 = (bi + off) * R;
      // entry (i, j) of the block: A(i, j) for j < M, g(i) for j = M,
      // chi2 for i = j = M; -1 below the diagonal and in the pad
      auto dst = [&](int a, int b) {
        const int i = i0 + a, j = j0 + b;
        return (i > j || j > M) ? -1 : j < M ? roff(i) + j : L.MT + i;
      };
      T acc[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const int d = dst(a, b);
          acc[a][b] = (k0 == 0 || d < 0) ? T(0) : out[d];
        }
      const T* row = v + L.cs;
#pragma unroll 2
      for (int kk = 0; kk < nc; ++kk, row += L.ld) {
        T x[R], y[R];
        load4(row + i0, x);
        load4(row + j0, y);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b) acc[a][b] = acc[a][b] + x[a] * y[b];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const int d = dst(a, b);
          if (d >= 0) out[d] = acc[a][b];
        }
    }
    __syncthreads();
  }

  // A, g, chi2 at the point in slot ``slot``
  __device__ void system(int slot) {
    transform(slot);
    for (int k0 = 0; k0 < prm.nk; k0 += L.kc) {
      const int nc = min(L.kc, prm.nk - k0);
      stage(slot, k0, nc);
      gram(slot, k0, nc);
    }
  }

  // lm.cuh's gcrit; the max over the components as a shuffle tree of
  // nan_max in every warp, so every thread has it
  __device__ T gcrit(int slot) {
    const int M = L.M, MT = L.MT;
    const T* A = sys(slot);
    const T* g = A + MT;
    const T* sn = v + L.sns + slot * M;
    const T* dp = v + L.dps + slot * M;
    const T sqc = sqrt(nan_max(A[MT + M], T(prm.eps)));
    const T sat = T(prm.sat);
    for (int i = tid; i < M; i += nt) {
      const T di = A[roff(i) + i];
      const bool dd = di <= T(1e-30);
      dead[i] = dd;
      v[L.scale + i] = di > T(1e-30) ? sqrt(di) : T(1);
      const T push = g[i] * dp[i];
      const bool kkt = (sn[i] > sat && push > T(0)) || (sn[i] < -sat && push < T(0));
      const T denom = sqrt(dd ? T(1) : di) * sqc;
      v[L.gv + i] = ((dd || kkt) ? T(0) : fabs(g[i])) / denom;
    }
    __syncthreads();
    const int lane = tid & 31;
    T m = v[L.gv + min(lane, M - 1)];
    for (int i = lane + 32; i < M; i += 32) m = nan_max(m, v[L.gv + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
    return m;
  }

  // The damped, Jacobi-scaled matrix S (the trial slot), and b into yv,
  // where the forward solve's running sums start.
  __device__ void scale(int slot, T lam, T* S) {
    const int M = L.M, MT = L.MT;
    const T* A = sys(slot);
    const T* g = A + MT;
    const T* sc = v + L.scale;
    const int tx = tid & (kTc - 1), ty = tid / kTc, tr = nt / kTc;
    for (int a = ty; a < M; a += tr) {
      const int ra = roff(a);
      for (int c = a + ((tx - a) & (kTc - 1)); c < M; c += kTc)
        S[ra + c] = a == c ? T(1) + lam
                           : ((dead[a] || dead[c]) ? T(0) : A[ra + c] / (sc[a] * sc[c]));
    }
    for (int i = tid; i < M; i += nt) v[L.yv + i] = dead[i] ? T(0) : g[i] / sc[i];
    __syncthreads();
  }

  // The factor of S in panels of kPanel rows, right-looking, and the
  // forward solve L y = b beside it; y to yv, L(j, j) to dg. Warp 0
  // factors a panel with no barrier inside it: every lane factors the
  // panel's kPanel x kPanel diagonal block alike (its d's, its L entries,
  // y of its rows), then each lane takes the panel rows' entries of its
  // columns past the block in registers, row by row. Then the whole team
  // gives each trailing entry (a, c), a past the panel, the panel's terms
  // L(j, a) L(j, c) in ascending j. Every entry takes its subtractions in
  // the plain version's order, j = 0, 1, ..., and every running sum of
  // the forward solve its terms k = 0, 1, ...
  __device__ void factor_forward(T* S) {
    const int M = L.M;
    const T ceps = T(prm.chol_eps);
    T* dg = v + L.dg;
    T* yv = v + L.yv;
    const int lane = tid & 31;
    const int tx = tid & (kTc - 1), ty = tid / kTc, tr = nt / kTc;
    for (int p0 = 0; p0 < M; p0 += kPanel) {
      const int p1 = min(p0 + kPanel, M);
      if (tid < 32) {
        const int np = p1 - p0;
        int rp[kPanel];
#pragma unroll
        for (int j = 0; j < kPanel; ++j) rp[j] = roff(min(p0 + j, M - 1));
        // the panel's diagonal block and the running sums of its rows,
        // read by every lane before lane 0 stores any
        T B[kPanel][kPanel], d[kPanel], ys[kPanel];
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          ys[j] = j < np ? yv[p0 + j] : T(0);
#pragma unroll
          for (int a = j; a < kPanel; ++a) B[j][a] = a < np ? S[rp[j] + p0 + a] : T(0);
        }
        __syncwarp();
        // the block factored by every lane alike, and y of its rows
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          if (j < np) {
            d[j] = sqrt(nan_max(B[j][j], ceps));
            const T dgj = B[j][j] / d[j];
#pragma unroll
            for (int a = j + 1; a < kPanel; ++a) B[j][a] = B[j][a] / d[j];
#pragma unroll
            for (int a = j + 1; a < kPanel; ++a)
#pragma unroll
              for (int b = a; b < kPanel; ++b) B[a][b] = B[a][b] - B[j][a] * B[j][b];
            T acc = ys[j];
#pragma unroll
            for (int i = 0; i < j; ++i) acc = acc - B[i][j] * ys[i];
            ys[j] = acc / dgj;
            if (lane == 0) {
              dg[p0 + j] = dgj;
              yv[p0 + j] = ys[j];
#pragma unroll
              for (int a = j + 1; a < kPanel; ++a)
                if (a < np) S[rp[j] + p0 + a] = B[j][a];
            }
          }
        }
        // the panel rows past the block, a lane a column: divided by their
        // d, each taking the earlier panel rows' terms in order; the
        // column's running sum of y takes the panel rows' terms
        for (int c = p1 + ((lane - p1) & 31); c < M; c += 32) {
          T x[kPanel];
#pragma unroll
          for (int j = 0; j < kPanel; ++j) x[j] = j < np ? S[rp[j] + c] : T(0);
          T yc = yv[c];
#pragma unroll
          for (int j = 0; j < kPanel; ++j) {
            if (j < np) {
              const T l = x[j] / d[j];
              S[rp[j] + c] = l;
#pragma unroll
              for (int a = j + 1; a < kPanel; ++a) x[a] = x[a] - B[j][a] * l;
              yc = yc - l * ys[j];
            }
          }
          yv[c] = yc;
        }
      }
      __syncthreads();
      if (p1 < M) {
        const int np = p1 - p0;
        int rj[kPanel];
#pragma unroll
        for (int q = 0; q < kPanel; ++q) rj[q] = roff(min(p0 + q, M - 1));
        for (int a = p1 + ((ty - p1) & (tr - 1)); a < M; a += tr) {
          const int ra = roff(a);
          T la[kPanel];
#pragma unroll
          for (int q = 0; q < kPanel; ++q) la[q] = q < np ? S[rj[q] + a] : T(0);
          for (int c = a + ((tx - a) & (kTc - 1)); c < M; c += kTc) {
            T x = S[ra + c];
#pragma unroll
            for (int q = 0; q < kPanel; ++q)
              if (q < np) x = x - la[q] * S[rj[q] + c];
            S[ra + c] = x;
          }
        }
        __syncthreads();
      }
    }
  }

  // L^T x = y in place in yv: warp 1 turns column k + 1 of the factor into
  // products L(q, k + 1) x(k + 1), q < k, while thread 0 finishes x(k);
  // thread 0 subtracts row r's terms k = r + 1, ..., M - 1 in turn.
  __device__ void back_solve(T* S) {
    const int M = L.M;
    T* yv = v + L.yv;
    const T* dg = v + L.dg;
    if (tid < 64) {
      T xn = T(0);  // x(r + 1), on thread 0
      for (int r = M - 1; r >= 0; --r) {
        if (tid >= 32) {
          if (r + 1 < M) {
            const T xk = yv[r + 1];
            for (int q = tid - 32; q < r; q += 32) {
              T* p = S + roff(q) + r + 1;
              *p = *p * xk;
            }
          }
        } else if (tid == 0) {
          const int rr = roff(r);
          T a = yv[r];
          if (r + 1 < M) a = a - S[rr + r + 1] * xn;
#pragma unroll 8
          for (int k = r + 2; k < M; ++k) a = a - S[rr + k];
          xn = a / dg[r];
          yv[r] = xn;
        }
        pair_sync();
      }
    }
    __syncthreads();
  }

  // the trial point u + delta into the trial slot
  __device__ void update(int slot) {
    const int M = L.M;
    const T* u = v + L.uv + slot * M;
    T* ut = v + L.uv + (1 - slot) * M;
    for (int i = tid; i < M; i += nt)
      ut[i] = u[i] + (dead[i] ? T(0) : v[L.yv + i] / v[L.scale + i]);
    __syncthreads();
  }

  // lm.cuh's step: the damped, Jacobi-scaled matrix into the trial slot,
  // its factor and solves, the trial point into the trial slot
  __device__ void step(int slot, T lam) {
    T* S = sys(1 - slot);
    scale(slot, lam, S);
    factor_forward(S);
    back_solve(S);
    update(slot);
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(NT, (kWideMinBlocks<T, NT>))
lm_wide_kernel(const T* __restrict__ coeffs, const T* __restrict__ x0,
               const T* __restrict__ yt, const T* __restrict__ wt,
               const T* __restrict__ u0, const T* __restrict__ lo,
               const T* __restrict__ hi, const T* __restrict__ pseed,
               const uint8_t* __restrict__ pmask,
               const uint8_t* __restrict__ active,
               const int* __restrict__ budget, const T* __restrict__ lam0,
               T* __restrict__ u_out, T* __restrict__ chi2_out,
               uint8_t* __restrict__ conv_out, int* __restrict__ niter_out,
               T* __restrict__ edm_out, T* __restrict__ lam_out, LMParams prm,
               int P, int kc) {
  const WideLayout L(P, prm.nk, kc);
  const int M = L.M;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = NT;
  const int lane = blockIdx.x;
  const size_t row = (size_t)lane * M;
  T lam = lam0[lane];
  if (!active[lane]) {
    for (int i = tid; i < M; i += nt) u_out[row + i] = u0[row + i];
    if (tid == 0) {
      chi2_out[lane] = T(0);
      conv_out[lane] = 0;
      niter_out[lane] = 0;
      edm_out[lane] = T(INFINITY);
      lam_out[lane] = lam;
    }
    return;
  }
  T* v = reinterpret_cast<T*>(smem);
  int* base = reinterpret_cast<int*>(v + L.end);
  uint8_t* ok = reinterpret_cast<uint8_t*>(base + P);
  uint8_t* dead = ok + M;
  const T* coef = coeffs + (size_t)lane * 4 * kSeg;
  for (int i = tid; i < 4 * kSeg; i += nt) v[i] = coef[i];
  for (int k = tid; k < prm.nk; k += nt) {
    v[L.y + k] = yt[(size_t)k * prm.n + lane];
    v[L.w + k] = wt[(size_t)k * prm.n + lane];
  }
  // the rows' pad columns stay zero
  for (int i = tid; i < kc * L.ld; i += nt) v[L.cs + i] = T(0);
  for (int i = tid; i < M; i += nt) {
    const T l = lo[row + i], h = hi[row + i];
    v[L.half + i] = T(0.5) * (h - l);
    v[L.mid + i] = T(0.5) * (h + l);
    v[L.seed + i] = pseed[row + i];
    ok[i] = pmask[row + i] != 0 && v[L.half + i] > T(0);
    v[L.uv + i] = u0[row + i];
  }
  for (int q = tid; q < P; q += nt) v[L.actp + q] = pmask[row + 2 + 2 * q] ? T(1) : T(0);
  __syncthreads();

  WideLane<T> W{L, v, base, ok, dead, prm, tid, nt, x0[lane]};
  int cur = 0;
  W.system(0);
  T chi2 = W.sys(0)[L.MT + M];
  const int bud = budget[lane];
  const T ftol = T(prm.ftol), gtol = T(prm.gtol);
  const T lam_up = T(prm.lam_up), lam_down = T(prm.lam_down);
  const T lam_min = T(prm.lam_min), lam_max = T(prm.lam_max);
  bool done = bud <= 0, conv = false;
  int n_iter = 0;
  T edm = T(INFINITY);
  for (int it = 0; it < prm.max_iter && !done; ++it) {
    const T gc = W.gcrit(cur);
    const bool conv_g = gc < gtol;
    W.step(cur, lam);
    W.system(1 - cur);
    const T chi2_try = W.sys(1 - cur)[L.MT + M];
    const bool good = isfinite(chi2_try) && chi2_try < chi2;
    const bool step = good && !conv_g;
    const T chi2_new = step ? chi2_try : chi2;
    if (step) cur = 1 - cur;
    const T lam_new = clip(step ? lam / lam_down : lam * lam_up, lam_min, lam_max);
    const T rel_impr = (chi2 - chi2_new) / nan_max(chi2, T(1));
    const bool conv_f = step && rel_impr < ftol;
    const bool conv_now = conv_g || conv_f;
    n_iter += 1;
    done = conv_now || n_iter >= bud;
    conv = conv || conv_now;
    chi2 = chi2_new;
    lam = lam_new;
    edm = gc;
  }
  for (int i = tid; i < M; i += nt) u_out[row + i] = v[L.uv + cur * M + i];
  if (tid == 0) {
    chi2_out[lane] = chi2;
    conv_out[lane] = conv ? 1 : 0;
    niter_out[lane] = n_iter;
    edm_out[lane] = edm;
    lam_out[lane] = lam;
  }
}

// The bins a chunk of a wide lane of P pulses over nk bins stages: all of
// them, or as many down to kChunkFloor, where the lane stays within
// kLaneBytes (eight lanes an SM); else kChunkFloor where the lane fits a
// block (optin bytes); else as many as fit; 0 where not even kMinChunk (or
// nk) fit.
static int wide_chunk(int p, int nk, size_t tsize, size_t optin) {
  if (p <= kMaxP) return 0;
  const auto fits = [&](int kc, size_t cap) {
    return WideLayout(p, nk, kc).bytes(tsize) <= cap;
  };
  const int all = nk > 1 ? nk : 1;
  const int floor = all < kChunkFloor ? all : kChunkFloor;
  for (int kc = all; kc >= floor; --kc)
    if (fits(kc, kLaneBytes)) return kc;
  const int lo = all < kMinChunk ? all : kMinChunk;
  for (int kc = floor; kc >= lo; --kc)
    if (fits(kc, optin)) return kc;
  return 0;
}

template <typename T, int NT>
static cudaError_t launch_team(int p, int kc, const void* const* in,
                               void* const* out, const LMParams& prm,
                               cudaStream_t st) {
  const size_t smem = WideLayout(p, prm.nk, kc).bytes(sizeof(T));
  const cudaError_t e = allow_smem(lm_wide_kernel<T, NT>, smem);
  if (e != cudaSuccess) return e;
  lm_wide_kernel<T, NT><<<prm.n, NT, smem, st>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const uint8_t*)in[8], (const uint8_t*)in[9], (const int*)in[10],
      (const T*)in[11], (T*)out[0], (T*)out[1], (uint8_t*)out[2],
      (int*)out[3], (T*)out[4], (T*)out[5], prm, p, kc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(int p, const void* const* in, void* const* out,
                        const LMParams& prm, cudaStream_t st) {
  const int kc = wide_chunk(p, prm.nk, sizeof(T), smem_optin());
  if (kc == 0) return cudaErrorInvalidValue;
  return 1 + 2 * p <= kTeamSmallM
             ? launch_team<T, kTeamSmall>(p, kc, in, out, prm, st)
             : launch_team<T, kTeamLarge>(p, kc, in, out, prm, st);
}

template cudaError_t launch_wide<float>(int, const void* const*, void* const*,
                                        const LMParams&, cudaStream_t);
template cudaError_t launch_wide<double>(int, const void* const*, void* const*,
                                         const LMParams&, cudaStream_t);

}  // namespace npswf

// The widest P a lane of nk fit bins takes at this dtype: the compiled
// widths, then the wide kernel while its lane fits a block.
extern "C" int npswf_lm_max_pulses(int dtype, int nk) {
  const size_t tsize = dtype == npswf::kFloat32 ? sizeof(float) : sizeof(double);
  const size_t optin = npswf::smem_optin();
  int p = npswf::kMaxP;
  while (npswf::wide_chunk(p + 1, nk, tsize, optin) > 0) ++p;
  return p;
}

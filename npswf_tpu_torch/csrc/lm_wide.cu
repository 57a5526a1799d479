// K3 at the wide widths: P > kMaxP (16 and up) with P taken at run time.
//
// The same LM stage as lm.cuh, a team of 32 threads (one warp, one block)
// per lane, with every sum in the plain version's order, so the kernel is
// bit-equal to lm_solve_plain. What differs is what lets M = 1 + 2P exceed
// the team:
//   - a thread owns rows tr, tr + 32, ... of the M x M system: the columns
//     of the Cholesky factor's rows, and the rows of the forward solve,
//     whose running sums live in shared memory (yv) instead of a register;
//   - the back solve runs on one thread, in place in yv (y_r is read
//     before d_r overwrites it; d_k for k > r is already there), so d[M]
//     leaves the registers; every sum still runs k = r + 1, ..., M - 1;
//   - the sums of A, g and chi2 are the upper triangle of the Gram matrix
//     of the bin rows [cols | r]; thread tr owns its entries tr, tr + 32,
//     ... (walked without a table), and adds each over the bins in order;
//   - the bins go in chunks of 32, one bin a thread: a chunk's columns take
//     32 (M + 1) values of shared memory, and each owner carries its sums
//     from chunk to chunk through their slots of the system, starting the
//     first chunk from zero;
//   - the damped matrix S lives in the trial point's slot of the system,
//     which step() overwrites anyway and system() rewrites after it.
// So the only limit is the block's shared memory (lm_wide_bytes): at
// K = 90 fit bins, P = 71 in fp64 on a card with 227 KB a block.
//
// Compiled with -fmad=false, as the rest.
#include "lm.cuh"

namespace npswf {

// shared-memory offsets, in values, of a wide lane's arrays
struct WideLayout {
  int P, M, MT, NE, nk;
  int y, w, cs, sys, uv, sns, dps, half, mid, seed, pp, scale, b, gv, dg, yv,
      uu, actp, end;

  __host__ __device__ WideLayout(int p, int nk_) : P(p), nk(nk_) {
    M = 1 + 2 * P;
    MT = M * (M + 1) / 2;
    NE = MT + M + 1;
    y = 4 * kSeg;
    w = y + nk;
    cs = w + nk;
    sys = cs + kTeam * (M + 1);
    uv = sys + 2 * NE;
    sns = uv + 2 * M;
    dps = sns + 2 * M;
    half = dps + 2 * M;
    mid = half + M;
    seed = mid + M;
    pp = seed + M;
    scale = pp + M;
    b = scale + M;
    gv = b + M;
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

__host__ __device__ inline int tri_rt(int M, int i, int j) {
  return i * (2 * M - i + 1) / 2 + (j - i);
}

// Walks the entries tr, tr + kTeam, ... of the upper triangle of a C x C
// matrix, row-major: (i, j) with j >= i.
struct TriWalk {
  int C, i, off;
  __device__ TriWalk(int C_, int first) : C(C_), i(0), off(first) { norm(); }
  __device__ void norm() {
    while (i < C && off >= C - i) { off -= C - i; ++i; }
  }
  __device__ bool ok() const { return i < C; }
  __device__ int j() const { return i + off; }
  __device__ void next() { off += kTeam; norm(); }
};

template <typename T, typename Tile>
struct WideLane {
  Tile tile;
  WideLayout L;
  T* v;          // the block's values
  int* base;     // [P]
  uint8_t* ok;   // [M]
  uint8_t* dead; // [M]
  LMParams prm;
  int tr;
  T x0;

  __device__ T* sys(int slot) const { return v + L.sys + slot * L.NE; }

  // A, g, chi2 at the point in slot ``slot``: the transform, then a chunk
  // of 32 bins at a time, (a) one bin a thread into shared memory,
  // (b) each owner's sums over the chunk's bins in order.
  __device__ void system(int slot) {
    const int M = L.M;
    const T* u = v + L.uv + slot * M;
    T* sn = v + L.sns + slot * M;
    T* dp = v + L.dps + slot * M;
    for (int i = tr; i < M; i += kTeam) {
      sn[i] = sin(u[i]);
      transform_one(sn[i], cos(u[i]), v[L.mid + i], v[L.half + i],
                    v[L.seed + i], ok[i] != 0, v[L.pp + i], dp[i]);
      if (i & 1) pulse_slot(v[L.pp + i], x0, prm.fit_lo, v[L.uu + i / 2], base[i / 2]);
    }
    tile.sync();
    const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
    T* cs = v + L.cs;
    T* out = sys(slot);
    for (int k0 = 0; k0 < prm.nk; k0 += kTeam) {
      const int nc = min(kTeam, prm.nk - k0);
      if (tr < nc) {
        const int k = k0 + tr;
        T* c = cs + (size_t)tr * (M + 1);
        bin_columns<T, 0>(k, prm.fit_lo, gate_lo, gate_hi, v[L.w + k],
                          v[L.y + k], v, v + L.pp, dp, v + L.uu, base,
                          v + L.actp, c, c[M], L.P);
      }
      tile.sync();
      for (TriWalk e(M + 1, tr); e.ok(); e.next()) {
        const int i = e.i, j = e.j();
        const int dst = j < M ? tri_rt(M, i, j) : L.MT + i;
        T acc = k0 == 0 ? T(0) : out[dst];
        for (int k = 0; k < nc; ++k) {
          const T* c = cs + (size_t)k * (M + 1);
          acc = acc + c[i] * c[j];
        }
        out[dst] = acc;
      }
      tile.sync();
    }
  }

  // lm.cuh's gcrit at run-time M
  __device__ T gcrit(int slot) {
    const int M = L.M, MT = L.MT;
    const T* A = sys(slot);
    const T* g = A + MT;
    const T* sn = v + L.sns + slot * M;
    const T* dp = v + L.dps + slot * M;
    const T sqc = sqrt(nan_max(A[MT + M], T(prm.eps)));
    const T sat = T(prm.sat);
    for (int i = tr; i < M; i += kTeam) {
      const T di = A[tri_rt(M, i, i)];
      const bool dd = di <= T(1e-30);
      dead[i] = dd;
      v[L.scale + i] = di > T(1e-30) ? sqrt(di) : T(1);
      const T push = g[i] * dp[i];
      const bool kkt = (sn[i] > sat && push > T(0)) || (sn[i] < -sat && push < T(0));
      const T denom = sqrt(dd ? T(1) : di) * sqc;
      v[L.gv + i] = ((dd || kkt) ? T(0) : fabs(g[i])) / denom;
    }
    tile.sync();
    T out = v[L.gv];
    for (int i = 1; i < M; ++i) out = nan_max(out, v[L.gv + i]);
    return out;
  }

  // The factor row by row: every thread the diagonal's subtractions, the
  // owner of column c (c mod 32 = tr) entry (a, c) for c > a, each in the
  // outer-product form's order; L(a, a) to dg by the owner of column a.
  __device__ void factor(T* S, T* dg) {
    const int M = L.M;
    const T ceps = T(prm.chol_eps);
    for (int a = 0; a < M; ++a) {
      T vd = S[tri_rt(M, a, a)];
      for (int j = 0; j < a; ++j) {
        const T la = S[tri_rt(M, j, a)];
        vd = vd - la * la;
      }
      const T d = sqrt(nan_max(vd, ceps));
      for (int c = tr; c < M; c += kTeam) {
        if (c <= a) continue;
        T x = S[tri_rt(M, a, c)];
        for (int j = 0; j < a; ++j)
          x = x - S[tri_rt(M, j, a)] * S[tri_rt(M, j, c)];
        S[tri_rt(M, a, c)] = x / d;
      }
      if ((a & (kTeam - 1)) == tr) dg[a] = vd / d;
      tile.sync();
    }
  }

  // L y = b with the rows' sums in yv, then L^T d = y by thread 0 in place;
  // d is left in yv.
  __device__ void solve(const T* S, const T* dg) {
    const int M = L.M;
    T* yv = v + L.yv;
    for (int i = tr; i < M; i += kTeam) yv[i] = v[L.b + i];
    for (int k = 0; k < M; ++k) {
      if ((k & (kTeam - 1)) == tr) yv[k] = yv[k] / dg[k];
      tile.sync();
      for (int i = tr; i < M; i += kTeam)
        if (i > k) yv[i] = yv[i] - S[tri_rt(M, k, i)] * yv[k];
    }
    tile.sync();
    if (tr == 0) {
      for (int r = M - 1; r >= 0; --r) {
        T a = yv[r];
        for (int k = r + 1; k < M; ++k) a = a - S[tri_rt(M, r, k)] * yv[k];
        yv[r] = a / dg[r];
      }
    }
    tile.sync();
  }

  // lm.cuh's step: the damped, Jacobi-scaled matrix into the trial slot,
  // its factor and solves, the trial point u + delta into the trial slot.
  __device__ void step(int slot, T lam) {
    const int M = L.M, MT = L.MT;
    const T* A = sys(slot);
    const T* g = A + MT;
    const T* scale = v + L.scale;
    T* S = sys(1 - slot);
    for (TriWalk e(M, tr); e.ok(); e.next()) {
      const int i = e.i, j = e.j(), p = tri_rt(M, i, j);
      S[p] = i == j ? T(1) + lam
                    : ((dead[i] || dead[j]) ? T(0) : A[p] / (scale[i] * scale[j]));
    }
    for (int i = tr; i < M; i += kTeam) v[L.b + i] = dead[i] ? T(0) : g[i] / scale[i];
    tile.sync();
    factor(S, v + L.dg);
    solve(S, v + L.dg);
    const T* u = v + L.uv + slot * M;
    T* ut = v + L.uv + (1 - slot) * M;
    for (int i = tr; i < M; i += kTeam)
      ut[i] = u[i] + (dead[i] ? T(0) : v[L.yv + i] / scale[i]);
    tile.sync();
  }
};

template <typename T>
__global__ void __launch_bounds__(kTeam)
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
               int P) {
  const WideLayout L(P, prm.nk);
  const int M = L.M;
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = cg::tiled_partition<kTeam>(cg::this_thread_block());
  const int tr = tile.thread_rank();
  const int lane = blockIdx.x;
  const size_t row = (size_t)lane * M;
  T lam = lam0[lane];
  if (!active[lane]) {
    for (int i = tr; i < M; i += kTeam) u_out[row + i] = u0[row + i];
    if (tr == 0) {
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
  for (int i = tr; i < 4 * kSeg; i += kTeam) v[i] = coef[i];
  for (int k = tr; k < prm.nk; k += kTeam) {
    v[L.y + k] = yt[(size_t)k * prm.n + lane];
    v[L.w + k] = wt[(size_t)k * prm.n + lane];
  }
  for (int i = tr; i < M; i += kTeam) {
    const T l = lo[row + i], h = hi[row + i];
    v[L.half + i] = T(0.5) * (h - l);
    v[L.mid + i] = T(0.5) * (h + l);
    v[L.seed + i] = pseed[row + i];
    ok[i] = pmask[row + i] != 0 && v[L.half + i] > T(0);
    v[L.uv + i] = u0[row + i];
  }
  for (int q = tr; q < P; q += kTeam) v[L.actp + q] = pmask[row + 2 + 2 * q] ? T(1) : T(0);
  tile.sync();

  WideLane<T, decltype(tile)> W{tile, L, v, base, ok, dead, prm, tr, x0[lane]};
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
  for (int i = tr; i < M; i += kTeam) u_out[row + i] = v[L.uv + cur * M + i];
  if (tr == 0) {
    chi2_out[lane] = chi2;
    conv_out[lane] = conv ? 1 : 0;
    niter_out[lane] = n_iter;
    edm_out[lane] = edm;
    lam_out[lane] = lam;
  }
}

static size_t smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)v;
}

// Whether a wide lane of P pulses over nk bins fits a block's shared memory.
static bool wide_fits(int p, int nk, size_t tsize) {
  return p > kMaxP && WideLayout(p, nk).bytes(tsize) <= smem_optin();
}

template <typename T>
cudaError_t launch_wide(int p, const void* const* in, void* const* out,
                        const LMParams& prm, cudaStream_t st) {
  if (!wide_fits(p, prm.nk, sizeof(T))) return cudaErrorInvalidValue;
  const size_t smem = WideLayout(p, prm.nk).bytes(sizeof(T));
  const cudaError_t e = allow_smem(lm_wide_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  lm_wide_kernel<T><<<prm.n, kTeam, smem, st>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const uint8_t*)in[8], (const uint8_t*)in[9], (const int*)in[10],
      (const T*)in[11], (T*)out[0], (T*)out[1], (uint8_t*)out[2],
      (int*)out[3], (T*)out[4], (T*)out[5], prm, p);
  return cudaGetLastError();
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
  int p = npswf::kMaxP;
  while (npswf::wide_fits(p + 1, nk, tsize)) ++p;
  return p;
}

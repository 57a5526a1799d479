// K3: one whole bounded Levenberg-Marquardt stage per lane, one thread per
// lane.
//
// Replaces npswf_tpu/fit/pallas_lm.py::_lm_kernel (wrappers _lm_call and
// lm_solve_pallas). Per lane, until it converges or spends its budget:
//   - the sin bound transform p = mid + half*sin(u);
//   - the spline model from the padded segment planes: the TPU kernel's
//     mod-SEG barrel shift becomes a direct load at segment slot
//     (fit_lo_bin + k - ceil(t + x0) + PAD) mod SEG, and the support gate
//     1 < x - t < ntime - 1 zeroes what lies outside;
//   - the weighted Jacobian columns of each fit bin, reduced at once into
//     the packed normal equations (A, g) and chi2 -- no Jacobian is stored;
//   - the MINPACK scaled-gradient test with the KKT active-bound mask;
//   - a Jacobi-scaled, Marquardt-damped Cholesky solve;
//   - accept (lambda / lambda_down) or reject (lambda * lambda_up), clipped,
//     with the normal equations of the current point cached across
//     rejected steps, and the relative-chi2 ftol test;
//   - per-lane budgets: a lane that spends its budget freezes unconverged.
// Inactive lanes return u0, chi2 = 0, conv = false, n_iter = 0, edm = inf
// and lambda = lambda0, as the XLA while-loop does. The system evaluation
// (transform, model, columns, normal equations) is SplineLane::system in
// spline_system.cuh, which K6 (eval.cu) launches on its own.
//
// What bounds it on the card: the per-thread state, 2M + M(M+1)/2 + 8
// values (33 at M = 5, 71 at M = 9, 383 at M = 25), plus a trial copy of
// the normal equations and the Cholesky factor. The narrow buckets fit in
// registers; the wide one (P = 12) spills to local memory, which is cached
// in L1/L2. Per iteration each lane reads 90 fit bins of y and w and
// 4 * 90 * P coefficients; the arithmetic is ~M(M+1)/2 multiply-adds a bin.
// What the design does about it: P is a template parameter so every loop
// over the parameter vector unrolls and the narrow state stays in
// registers; y and w arrive lanes-minor ([K, N]) so their loads coalesce;
// a lane exits its loop as soon as it is done, so converged lanes free
// their warp slot early. Compiled with -fmad=false so each product and sum
// rounds as in the plain PyTorch version.
#include "spline_system.cuh"

namespace npswf {

struct LMParams {
  double lam_up, lam_down, lam_min, lam_max, ftol, gtol, eps, gate_lo,
      gate_hi, sat, chol_eps;
  int fit_lo, nk, n, max_iter;
};

// The shared system evaluation (spline_system.cuh) plus the LM step.
template <typename T, int P>
struct Lane : SplineLane<T, P> {
  using Base = SplineLane<T, P>;
  static constexpr int M = Base::M;
  static constexpr int MT = Base::MT;

  // MINPACK scaled gradient over the KKT-free components.
  __device__ T gcrit(const LMParams& prm, const T* A, const T* g, T chi2,
                     const T* u) const {
    const T sqc = sqrt(nan_max(chi2, T(prm.eps)));
    const T sat = T(prm.sat);
    T out = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T di = A[tri<M>(i, i)];
      const bool dead = di <= T(1e-30);
      const T push = g[i] * (this->ok[i] ? this->half[i] * cos(u[i]) : T(0));
      const T si = sin(u[i]);
      const bool kkt = (si > sat && push > T(0)) || (si < -sat && push < T(0));
      const T denom = sqrt(dead ? T(1) : di) * sqc;
      const T v = ((dead || kkt) ? T(0) : fabs(g[i])) / denom;
      out = (i == 0) ? v : nan_max(out, v);
    }
    return out;
  }

  // Jacobi-scaled damped step: solve (D^-1 A D^-1 + lam I) (D delta) = D^-1 g
  // by an outer-product Cholesky on the packed matrix, in place.
  __device__ void solve_damped(const LMParams& prm, const T* A, const T* g,
                               T lam, T* delta) const {
    T scale[M];
    bool dead[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T di = A[tri<M>(i, i)];
      dead[i] = di <= T(1e-30);
      scale[i] = di > T(1e-30) ? sqrt(di) : T(1);  // NaN: neither dead nor scaled
    }
    T S[MT];
    T b[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i; j < M; ++j) {
        if (i == j)
          S[tri<M>(i, j)] = T(1) + lam;
        else
          S[tri<M>(i, j)] = (dead[i] || dead[j])
                                ? T(0)
                                : A[tri<M>(i, j)] / (scale[i] * scale[j]);
      }
      b[i] = dead[i] ? T(0) : g[i] / scale[i];
    }
    const T ceps = T(prm.chol_eps);
    // L[i][j] (i >= j) overwrites S at tri(j, i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T d = sqrt(nan_max(S[tri<M>(j, j)], ceps));
#pragma unroll
      for (int i = j; i < M; ++i) S[tri<M>(j, i)] = S[tri<M>(j, i)] / d;
#pragma unroll
      for (int a = j + 1; a < M; ++a) {
#pragma unroll
        for (int c = a; c < M; ++c)
          S[tri<M>(a, c)] = S[tri<M>(a, c)] - S[tri<M>(j, a)] * S[tri<M>(j, c)];
      }
    }
    T y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = b[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - S[tri<M>(k, i)] * y[k];
      y[i] = acc / S[tri<M>(i, i)];
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      T acc = y[i];
#pragma unroll
      for (int k = i + 1; k < M; ++k) acc = acc - S[tri<M>(i, k)] * delta[k];
      delta[i] = acc / S[tri<M>(i, i)];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) delta[i] = dead[i] ? T(0) : delta[i] / scale[i];
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(kBlock)
lm_kernel(const T* __restrict__ coeffs, const T* __restrict__ x0,
          const T* __restrict__ yt, const T* __restrict__ wt,
          const T* __restrict__ u0, const T* __restrict__ lo,
          const T* __restrict__ hi, const T* __restrict__ pseed,
          const uint8_t* __restrict__ pmask, const uint8_t* __restrict__ active,
          const int* __restrict__ budget, const T* __restrict__ lam0,
          T* __restrict__ u_out, T* __restrict__ chi2_out,
          uint8_t* __restrict__ conv_out, int* __restrict__ niter_out,
          T* __restrict__ edm_out, T* __restrict__ lam_out, LMParams prm) {
  using LaneT = Lane<T, P>;
  constexpr int M = LaneT::M;
  constexpr int MT = LaneT::MT;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= prm.n) return;
  const size_t row = (size_t)lane * M;
  T u[M];
#pragma unroll
  for (int i = 0; i < M; ++i) u[i] = u0[row + i];
  T lam = lam0[lane];
  if (!active[lane]) {
#pragma unroll
    for (int i = 0; i < M; ++i) u_out[row + i] = u[i];
    chi2_out[lane] = T(0);
    conv_out[lane] = 0;
    niter_out[lane] = 0;
    edm_out[lane] = T(INFINITY);
    lam_out[lane] = lam;
    return;
  }
  LaneT s;
  s.load(coeffs, x0, yt, wt, lo, hi, pseed, pmask, lane);

  T A[MT], g[M], chi2;
  s.system(prm, u, A, g, chi2);
  const int bud = budget[lane];
  const T ftol = T(prm.ftol), gtol = T(prm.gtol);
  const T lam_up = T(prm.lam_up), lam_down = T(prm.lam_down);
  const T lam_min = T(prm.lam_min), lam_max = T(prm.lam_max);
  bool done = bud <= 0, conv = false;
  int n_iter = 0;
  T edm = T(INFINITY);
  for (int it = 0; it < prm.max_iter && !done; ++it) {
    const T gc = s.gcrit(prm, A, g, chi2, u);
    const bool conv_g = gc < gtol;
    T delta[M], ut[M];
    s.solve_damped(prm, A, g, lam, delta);
#pragma unroll
    for (int i = 0; i < M; ++i) ut[i] = u[i] + delta[i];
    T At[MT], gt[M], chi2_try;
    s.system(prm, ut, At, gt, chi2_try);
    const bool good = isfinite(chi2_try) && chi2_try < chi2;
    const bool step = good && !conv_g;
    const T chi2_new = step ? chi2_try : chi2;
    if (step) {
#pragma unroll
      for (int i = 0; i < M; ++i) u[i] = ut[i];
#pragma unroll
      for (int i = 0; i < MT; ++i) A[i] = At[i];
#pragma unroll
      for (int i = 0; i < M; ++i) g[i] = gt[i];
    }
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
#pragma unroll
  for (int i = 0; i < M; ++i) u_out[row + i] = u[i];
  chi2_out[lane] = chi2;
  conv_out[lane] = conv ? 1 : 0;
  niter_out[lane] = n_iter;
  edm_out[lane] = edm;
  lam_out[lane] = lam;
}

template <typename T, int P>
static void launch(const void* const* in, void* const* out,
                   const LMParams& prm, cudaStream_t st) {
  lm_kernel<T, P><<<grid_for(prm.n), kBlock, 0, st>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const uint8_t*)in[8], (const uint8_t*)in[9], (const int*)in[10],
      (const T*)in[11], (T*)out[0], (T*)out[1], (uint8_t*)out[2],
      (int*)out[3], (T*)out[4], (T*)out[5], prm);
}

template <typename T>
static bool dispatch(int p, const void* const* in, void* const* out,
                     const LMParams& prm, cudaStream_t st) {
  switch (p) {
    case 1: launch<T, 1>(in, out, prm, st); return true;
    case 2: launch<T, 2>(in, out, prm, st); return true;
    case 3: launch<T, 3>(in, out, prm, st); return true;
    case 4: launch<T, 4>(in, out, prm, st); return true;
    case 6: launch<T, 6>(in, out, prm, st); return true;
    case 8: launch<T, 8>(in, out, prm, st); return true;
    case 12: launch<T, 12>(in, out, prm, st); return true;
    default: return false;
  }
}

}  // namespace npswf

// Pulse counts with a compiled instantiation.
extern "C" int npswf_lm_supported(int p) {
  return p == 1 || p == 2 || p == 3 || p == 4 || p == 6 || p == 8 || p == 12;
}

// in: coeffs, x0, yt, wt, u0, lo, hi, pseed, pmask, active, budget, lam0
// out: u, chi2, conv, n_iter, edm, lam
extern "C" int npswf_lm_solve(int dtype, int p, const void* const* in,
                              void* const* out, int n, int nk, int fit_lo,
                              int max_iter, double lam_up, double lam_down,
                              double lam_min, double lam_max, double ftol,
                              double gtol, double eps, double gate_lo,
                              double gate_hi, double sat, double chol_eps,
                              void* stream) {
  npswf::LMParams prm;
  prm.lam_up = lam_up;
  prm.lam_down = lam_down;
  prm.lam_min = lam_min;
  prm.lam_max = lam_max;
  prm.ftol = ftol;
  prm.gtol = gtol;
  prm.eps = eps;
  prm.gate_lo = gate_lo;
  prm.gate_hi = gate_hi;
  prm.sat = sat;
  prm.chol_eps = chol_eps;
  prm.fit_lo = fit_lo;
  prm.nk = nk;
  prm.n = n;
  prm.max_iter = max_iter;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = dtype == npswf::kFloat32
                      ? npswf::dispatch<float>(p, in, out, prm, st)
                      : npswf::dispatch<double>(p, in, out, prm, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

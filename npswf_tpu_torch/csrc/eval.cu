// K5, K6 and K7: the system evaluations of the generic LM loop.
//
// K5 fused_eval replaces npswf_tpu/fit/pallas_eval.py::_kernel (wrapper
// fused_eval): the spline model f [N, K] and the per-pulse Jacobian windows
// Jt = -A * s'(x - t) and Ja = s(x - t), each [N, P, K], over the fit bins.
// One thread per (lane, fit bin), looping over the P pulses in order: u =
// ceil(t + x0) - (t + x0), the four coefficients at segment slot
// (fit_lo + PAD + k - ceil(t + x0)) mod SEG (the TPU kernel's barrel shift
// as a direct load, wrapping for t + x0 > fit_lo + PAD - 1), Horner for the
// value and the derivative, the support gate 1 < x - t < ntime - 1 and the
// pulse mask; f accumulates from the pedestal in pulse order.
// What bounds it on the card: device memory. At P = 2 and N = 69,120 it
// reads the [N, 4, 128] planes (141.6 MB in fp32) and writes f, Jt and Ja
// (124.4 MB); the arithmetic is ~20 flops an output. What the design does
// about it: consecutive threads take consecutive fit bins of one lane, so
// the output rows are written coalesced and each lane's coefficient window
// is read as contiguous runs; nothing is staged.
//
// K6 fused_system replaces npswf_tpu/fit/pallas_eval.py::_system_kernel
// (wrapper fused_system): transform, model, Jacobian columns and the packed
// normal equations A (upper triangle), g and chi2 in one call, one thread
// per lane. It is SplineLane::system (spline_system.cuh), the evaluation K3
// runs inside its loop, so the two round alike.
// What bounds it: device memory, 206 MB at P = 2 (the planes, y and w, the
// [N, M] parameter rows); at P = 12 the M(M+1)/2 = 325 accumulators spill
// to local memory, as in K3. Design: y and w arrive lanes-minor ([K, N]) so
// a warp's loads of one bin coalesce, and the outputs are written
// lanes-minor ([MT + M + 1, N]) for the same reason.
//
// K7 fused_neq replaces npswf_tpu/fit/pallas_eval.py::_neq_kernel (wrapper
// fused_neq): A, g and chi2 from K5's outputs and dp/du, one thread per
// lane, P in 1..4 as template instances (the TPU path's NARROW_P limit).
// Per bin k, in order: cols = [dpdu_0 w, jt_p dpdu w, ja_p dpdu w, ...], r =
// (y - f) w, and the M(M+1)/2 + M + 1 sums, the column arithmetic of K3.
// What bounds it: device memory, 184 MB at P = 2 (y, w, f, Jt, Ja, dpdu).
// Design: y, w and f lanes-minor; Jt and Ja are read as each lane's own
// contiguous rows, served from L1 after the first touch of a sector.
//
// Compiled with -fmad=false: each product and sum rounds as in the plain
// PyTorch versions (fit/eval_kernel.py), which sum over the bins in order.
#include "spline_system.cuh"

namespace npswf {

struct SysParams {
  double gate_lo, gate_hi;
  int fit_lo, nk, n;
};

// ---- K5 -------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kBlock)
eval_kernel(const T* __restrict__ coeffs, const T* __restrict__ x0,
            const T* __restrict__ tpar, const T* __restrict__ apar,
            const T* __restrict__ ped, const uint8_t* __restrict__ mask,
            T* __restrict__ f, T* __restrict__ jt, T* __restrict__ ja,
            SysParams prm, int p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)prm.n * prm.nk) return;
  const int lane = (int)(idx / prm.nk);
  const int k = (int)(idx % prm.nk);
  const T* coef = coeffs + (size_t)lane * 4 * kSeg;
  const T xk = T(k) + T(prm.fit_lo);
  const T x0l = x0[lane];
  const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
  T acc = ped[lane];
  for (int q = 0; q < p; ++q) {
    const size_t pq = (size_t)lane * p + q;
    const T tp = tpar[pq], amp = apar[pq];
    const T act = mask[pq] ? T(1) : T(0);
    const T tau = tp + x0l;
    const T ceil_t = ceil(tau);
    const T uu = ceil_t - tau;
    const long long b = (long long)prm.fit_lo + kPad - (long long)ceil_t + k;
    const int s = (int)(((b % kSeg) + kSeg) % kSeg);
    const T ca = coef[s], cb = coef[kSeg + s], cc = coef[2 * kSeg + s],
            cd = coef[3 * kSeg + s];
    const T sval = ((cd * uu + cc) * uu + cb) * uu + ca;
    const T sder = (T(3) * cd * uu + T(2) * cc) * uu + cb;
    const T rel = xk - tp;
    const bool gate = rel > gate_lo && rel < gate_hi;
    const T val = (gate ? sval : T(0)) * act;
    const T der = (gate ? sder : T(0)) * act;
    acc = acc + amp * val;
    jt[pq * prm.nk + k] = -amp * der;
    ja[pq * prm.nk + k] = val;
  }
  f[(size_t)lane * prm.nk + k] = acc;
}

// ---- K6 -------------------------------------------------------------
template <typename T, int P>
__global__ void __launch_bounds__(kBlock)
system_kernel(const T* __restrict__ coeffs, const T* __restrict__ x0,
              const T* __restrict__ yt, const T* __restrict__ wt,
              const T* __restrict__ u, const T* __restrict__ lo,
              const T* __restrict__ hi, const T* __restrict__ pseed,
              const uint8_t* __restrict__ pmask, T* __restrict__ out,
              SysParams prm) {
  using LaneT = SplineLane<T, P>;
  constexpr int M = LaneT::M;
  constexpr int MT = LaneT::MT;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= prm.n) return;
  LaneT s;
  s.load(coeffs, x0, yt, wt, lo, hi, pseed, pmask, lane);
  T uu[M];
#pragma unroll
  for (int i = 0; i < M; ++i) uu[i] = u[(size_t)lane * M + i];
  T A[MT], g[M], chi2;
  s.system(prm, uu, A, g, chi2);
#pragma unroll
  for (int i = 0; i < MT; ++i) out[(size_t)i * prm.n + lane] = A[i];
#pragma unroll
  for (int i = 0; i < M; ++i) out[(size_t)(MT + i) * prm.n + lane] = g[i];
  out[(size_t)(MT + M) * prm.n + lane] = chi2;
}

// ---- K7 -------------------------------------------------------------
template <typename T, int P>
__global__ void __launch_bounds__(kBlock)
neq_kernel(const T* __restrict__ yt, const T* __restrict__ wt,
           const T* __restrict__ ft, const T* __restrict__ jt,
           const T* __restrict__ ja, const T* __restrict__ dpdu,
           T* __restrict__ out, int n, int nk) {
  constexpr int M = 1 + 2 * P;
  constexpr int MT = M * (M + 1) / 2;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  T dp[M];
#pragma unroll
  for (int i = 0; i < M; ++i) dp[i] = dpdu[(size_t)lane * M + i];
  const T* jtl = jt + (size_t)lane * P * nk;
  const T* jal = ja + (size_t)lane * P * nk;
  T A[MT], g[M];
  T chi2 = T(0);
#pragma unroll
  for (int i = 0; i < MT; ++i) A[i] = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i) g[i] = T(0);
  for (int k = 0; k < nk; ++k) {
    const size_t o = (size_t)k * n + lane;
    const T wk = wt[o];
    const T r = (yt[o] - ft[o]) * wk;
    T col[M];
    col[0] = dp[0] * wk;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      col[1 + 2 * q] = jtl[q * nk + k] * dp[1 + 2 * q] * wk;
      col[2 + 2 * q] = jal[q * nk + k] * dp[2 + 2 * q] * wk;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i; j < M; ++j) A[tri<M>(i, j)] = A[tri<M>(i, j)] + col[i] * col[j];
      g[i] = g[i] + col[i] * r;
    }
    chi2 = chi2 + r * r;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) out[(size_t)i * n + lane] = A[i];
#pragma unroll
  for (int i = 0; i < M; ++i) out[(size_t)(MT + i) * n + lane] = g[i];
  out[(size_t)(MT + M) * n + lane] = chi2;
}

template <typename T, int P>
static void launch_system(const void* const* in, void* out,
                          const SysParams& prm, cudaStream_t st) {
  system_kernel<T, P><<<grid_for(prm.n), kBlock, 0, st>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
      (const uint8_t*)in[8], (T*)out, prm);
}

template <typename T>
static bool dispatch_system(int p, const void* const* in, void* out,
                            const SysParams& prm, cudaStream_t st) {
  switch (p) {
    case 1: launch_system<T, 1>(in, out, prm, st); return true;
    case 2: launch_system<T, 2>(in, out, prm, st); return true;
    case 3: launch_system<T, 3>(in, out, prm, st); return true;
    case 4: launch_system<T, 4>(in, out, prm, st); return true;
    case 6: launch_system<T, 6>(in, out, prm, st); return true;
    case 8: launch_system<T, 8>(in, out, prm, st); return true;
    case 12: launch_system<T, 12>(in, out, prm, st); return true;
    default: return false;
  }
}

template <typename T, int P>
static void launch_neq(const void* const* in, void* out, int n, int nk,
                       cudaStream_t st) {
  neq_kernel<T, P><<<grid_for(n), kBlock, 0, st>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
      (const T*)in[4], (const T*)in[5], (T*)out, n, nk);
}

template <typename T>
static bool dispatch_neq(int p, const void* const* in, void* out, int n,
                         int nk, cudaStream_t st) {
  switch (p) {
    case 1: launch_neq<T, 1>(in, out, n, nk, st); return true;
    case 2: launch_neq<T, 2>(in, out, n, nk, st); return true;
    case 3: launch_neq<T, 3>(in, out, n, nk, st); return true;
    case 4: launch_neq<T, 4>(in, out, n, nk, st); return true;
    default: return false;
  }
}

}  // namespace npswf

// Pulse counts with a compiled K6 instantiation (K3's set).
extern "C" int npswf_system_supported(int p) {
  return p == 1 || p == 2 || p == 3 || p == 4 || p == 6 || p == 8 || p == 12;
}

extern "C" int npswf_fused_eval(int dtype, const void* coeffs, const void* x0,
                                const void* tpar, const void* apar,
                                const void* ped, const void* mask, void* f,
                                void* jt, void* ja, int n, int p, int nk,
                                int fit_lo, double gate_lo, double gate_hi,
                                void* stream) {
  npswf::SysParams prm;
  prm.gate_lo = gate_lo;
  prm.gate_hi = gate_hi;
  prm.fit_lo = fit_lo;
  prm.nk = nk;
  prm.n = n;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)n * nk;
  const int grid = (int)((total + npswf::kBlock - 1) / npswf::kBlock);
  if (dtype == npswf::kFloat32)
    npswf::eval_kernel<float><<<grid, npswf::kBlock, 0, st>>>(
        (const float*)coeffs, (const float*)x0, (const float*)tpar,
        (const float*)apar, (const float*)ped, (const uint8_t*)mask, (float*)f,
        (float*)jt, (float*)ja, prm, p);
  else
    npswf::eval_kernel<double><<<grid, npswf::kBlock, 0, st>>>(
        (const double*)coeffs, (const double*)x0, (const double*)tpar,
        (const double*)apar, (const double*)ped, (const uint8_t*)mask,
        (double*)f, (double*)jt, (double*)ja, prm, p);
  return (int)cudaGetLastError();
}

// in: yt, wt, ft, jt, ja, dpdu; out: [MT + M + 1, N]
extern "C" int npswf_fused_neq(int dtype, int p, const void* const* in,
                               void* out, int n, int nk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = dtype == npswf::kFloat32
                      ? npswf::dispatch_neq<float>(p, in, out, n, nk, st)
                      : npswf::dispatch_neq<double>(p, in, out, n, nk, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in: coeffs, x0, yt, wt, u, lo, hi, pseed, pmask; out: [MT + M + 1, N]
extern "C" int npswf_fused_system(int dtype, int p, const void* const* in,
                                  void* out, int n, int nk, int fit_lo,
                                  double gate_lo, double gate_hi, void* stream) {
  npswf::SysParams prm;
  prm.gate_lo = gate_lo;
  prm.gate_hi = gate_hi;
  prm.fit_lo = fit_lo;
  prm.nk = nk;
  prm.n = n;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = dtype == npswf::kFloat32
                      ? npswf::dispatch_system<float>(p, in, out, prm, st)
                      : npswf::dispatch_system<double>(p, in, out, prm, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The spline-model system evaluation shared by K3 (lm.cu, a team of threads
// per lane, inside its LM loop) and K6 (eval.cu, one thread per lane, one
// evaluation per launch).
//
// For one lane at internal point u: the sin bound transform, the spline
// model from the padded segment planes, the weighted Jacobian columns of
// each fit bin, reduced in bin order into the packed normal equations
// (upper triangle of A, row-major), g and chi2. The TPU kernels' mod-SEG
// barrel shift is a direct load at segment slot
// (fit_lo + PAD + k - ceil(t + x0)) mod SEG.
//
// The arithmetic of one component, one pulse and one fit bin lives in
// transform_one, pulse_slot and bin_columns below; both kernels call them,
// so K3, K6 and the plain versions round alike.
#pragma once

#include "common.cuh"

namespace npswf {

constexpr int kPad = 16;   // left padding of the segment planes (PAD)
constexpr int kSeg = 128;  // padded segment-plane width (SEG)

template <int M>
__host__ __device__ constexpr int tri(int i, int j) {
  // packed upper triangle, row-major, i <= j
  return i * (2 * M - i + 1) / 2 + (j - i);
}

// The sin bound transform of one component from su = sin(u) and cu =
// cos(u): p = mid + half su and dp/du = half cu, or the seed and 0 for a
// fixed component.
template <typename T>
__device__ __forceinline__ void transform_one(T su, T cu, T mid, T half,
                                              T seed, bool ok, T& p, T& dp) {
  const T pv = mid + half * su;
  p = ok ? pv : seed;
  dp = ok ? half * cu : T(0);
}

// A pulse at time tp: its spline fraction uu = ceil(tp + x0) - (tp + x0)
// and the segment slot of fit bin 0; bin k reads slot (base + k) mod SEG.
template <typename T>
__device__ __forceinline__ void pulse_slot(T tp, T x0, int fit_lo, T& uu,
                                           int& base) {
  const T tau = tp + x0;
  const T ceil_t = ceil(tau);
  uu = ceil_t - tau;
  const long long b = (long long)fit_lo + kPad - (long long)ceil_t;
  base = (int)(((b % kSeg) + kSeg) % kSeg);
}

// Fit bin k of one lane: the M weighted Jacobian columns col[0..M-1] and
// the weighted residual r. pp and dp are the transform's outputs, uu, base
// and actp (1 or 0) each pulse's fraction, slot and mask, coef the lane's
// [4, SEG] planes.
template <typename T, int P>
__device__ __forceinline__ void bin_columns(int k, int fit_lo, T gate_lo,
                                            T gate_hi, T wk, T yk,
                                            const T* coef, const T* pp,
                                            const T* dp, const T* uu,
                                            const int* base, const T* actp,
                                            T* col, T& r) {
  const T xk = T(k) + T(fit_lo);
  T f = pp[0];
  col[0] = dp[0] * wk;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const T tp = pp[1 + 2 * q], amp = pp[2 + 2 * q];
    const int s = (base[q] + k) & (kSeg - 1);
    const T ca = coef[s], cb = coef[kSeg + s], cc = coef[2 * kSeg + s],
            cd = coef[3 * kSeg + s];
    const T sval = ((cd * uu[q] + cc) * uu[q] + cb) * uu[q] + ca;
    const T sder = (T(3) * cd * uu[q] + T(2) * cc) * uu[q] + cb;
    const T rel = xk - tp;
    const bool gate = rel > gate_lo && rel < gate_hi;
    const T val = (gate ? sval : T(0)) * actp[q];
    const T der = (gate ? sder : T(0)) * actp[q];
    f = f + amp * val;
    col[1 + 2 * q] = -amp * der * dp[1 + 2 * q] * wk;
    col[2 + 2 * q] = val * dp[2 + 2 * q] * wk;
  }
  r = (yk - f) * wk;
}

// One thread per lane (K6). Prm carries fit_lo, nk (fit bins), n (lanes),
// gate_lo and gate_hi.
template <typename T, int P>
struct SplineLane {
  static constexpr int M = 1 + 2 * P;
  static constexpr int MT = M * (M + 1) / 2;

  const T* coef;  // [4, SEG] planes of this lane
  const T* yt;    // [K, N]
  const T* wt;
  int lane;
  T x0;
  T half[M], mid[M], pseed[M];
  bool ok[M];
  T actp[P];

  // Bounds, seeds and masks of lane ``lane`` from [N, M] rows.
  __device__ void load(const T* coeffs, const T* x0s, const T* yt_, const T* wt_,
                       const T* lo, const T* hi, const T* ps,
                       const uint8_t* pmask, int lane_) {
    lane = lane_;
    coef = coeffs + (size_t)lane * 4 * kSeg;
    yt = yt_;
    wt = wt_;
    x0 = x0s[lane];
    const size_t row = (size_t)lane * M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T l = lo[row + i], h = hi[row + i];
      half[i] = T(0.5) * (h - l);
      mid[i] = T(0.5) * (h + l);
      pseed[i] = ps[row + i];
      ok[i] = pmask[row + i] != 0 && half[i] > T(0);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) actp[q] = pmask[row + 2 + 2 * q] ? T(1) : T(0);
  }

  // Packed normal equations, gradient and chi2 at internal point u.
  template <typename Prm>
  __device__ void system(const Prm& prm, const T* u, T* A, T* g,
                         T& chi2) const {
    T pp[M], dp[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      transform_one(sin(u[i]), cos(u[i]), mid[i], half[i], pseed[i], ok[i],
                    pp[i], dp[i]);
    T uu[P];
    int base[P];
#pragma unroll
    for (int q = 0; q < P; ++q) pulse_slot(pp[1 + 2 * q], x0, prm.fit_lo, uu[q], base[q]);
#pragma unroll
    for (int i = 0; i < MT; ++i) A[i] = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = T(0);
    chi2 = T(0);
    const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
    for (int k = 0; k < prm.nk; ++k) {
      T col[M], r;
      bin_columns<T, P>(k, prm.fit_lo, gate_lo, gate_hi,
                        wt[(size_t)k * prm.n + lane], yt[(size_t)k * prm.n + lane],
                        coef, pp, dp, uu, base, actp, col, r);
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = i; j < M; ++j) A[tri<M>(i, j)] = A[tri<M>(i, j)] + col[i] * col[j];
        g[i] = g[i] + col[i] * r;
      }
      chi2 = chi2 + r * r;
    }
  }
};

}  // namespace npswf

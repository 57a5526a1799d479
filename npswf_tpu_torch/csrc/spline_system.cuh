// The per-lane spline-model system evaluation shared by K3 (lm.cu, inside
// its LM loop) and K6 (eval.cu, one evaluation per launch).
//
// For one lane at internal point u: the sin bound transform, the spline
// model from the padded segment planes, the weighted Jacobian columns of
// each fit bin, reduced in bin order into the packed normal equations
// (upper triangle of A, row-major), g and chi2. The TPU kernels' mod-SEG
// barrel shift is a direct load at segment slot
// (fit_lo + PAD + k - ceil(t + x0)) mod SEG.
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

// Prm carries fit_lo, nk (fit bins), n (lanes), gate_lo and gate_hi.
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
    for (int i = 0; i < M; ++i) {
      const T pv = mid[i] + half[i] * sin(u[i]);
      pp[i] = ok[i] ? pv : pseed[i];
      dp[i] = ok[i] ? half[i] * cos(u[i]) : T(0);
    }
    T uu[P], tp[P], amp[P];
    int base[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      tp[q] = pp[1 + 2 * q];
      amp[q] = pp[2 + 2 * q];
      const T tau = tp[q] + x0;
      const T ceil_t = ceil(tau);
      uu[q] = ceil_t - tau;
      // slot of bin k = (base + k) mod SEG, base = fit_lo + PAD - ceil(tau)
      const long long b = (long long)prm.fit_lo + kPad - (long long)ceil_t;
      base[q] = (int)(((b % kSeg) + kSeg) % kSeg);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) A[i] = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = T(0);
    chi2 = T(0);
    const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
    for (int k = 0; k < prm.nk; ++k) {
      const T xk = T(k) + T(prm.fit_lo);
      const T wk = wt[(size_t)k * prm.n + lane];
      const T yk = yt[(size_t)k * prm.n + lane];
      T col[M];
      T f = pp[0];
      col[0] = dp[0] * wk;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int s = (base[q] + k) & (kSeg - 1);
        const T ca = coef[s], cb = coef[kSeg + s], cc = coef[2 * kSeg + s],
                cd = coef[3 * kSeg + s];
        const T sval = ((cd * uu[q] + cc) * uu[q] + cb) * uu[q] + ca;
        const T sder = (T(3) * cd * uu[q] + T(2) * cc) * uu[q] + cb;
        const T rel = xk - tp[q];
        const bool gate = rel > gate_lo && rel < gate_hi;
        const T val = (gate ? sval : T(0)) * actp[q];
        const T der = (gate ? sder : T(0)) * actp[q];
        f = f + amp[q] * val;
        col[1 + 2 * q] = -amp[q] * der * dp[1 + 2 * q] * wk;
        col[2 + 2 * q] = val * dp[2 + 2 * q] * wk;
      }
      const T r = (yk - f) * wk;
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

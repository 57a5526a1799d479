// The spline-model system evaluation shared by K3 (lm.cuh, a team of threads
// per lane, inside its LM loop) and K6 (eval.cu, a tile of lanes a block, one
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
// [4, SEG] planes. The pulse count is P, or np where P is 0 (K6 takes it at
// run time; K3's compile-time P unrolls the pulse loop).
template <typename T, int P>
__device__ __forceinline__ void bin_columns(int k, int fit_lo, T gate_lo,
                                            T gate_hi, T wk, T yk,
                                            const T* coef, const T* pp,
                                            const T* dp, const T* uu,
                                            const int* base, const T* actp,
                                            T* col, T& r, int np = P) {
  const int npulse = P > 0 ? P : np;
  const T xk = T(k) + T(fit_lo);
  T f = pp[0];
  col[0] = dp[0] * wk;
#pragma unroll
  for (int q = 0; q < npulse; ++q) {
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

}  // namespace npswf

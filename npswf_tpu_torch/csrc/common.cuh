// Shared helpers for the port's hand-written kernels.
//
// A lane is one event x block waveform. K1, K2 and K4-K7 run one thread
// per lane (K5 one per lane and fit bin); K3 runs a team of threads, one
// warp, per lane (lm.cu). Every kernel is compiled with -fmad=false: each
// multiply and add rounds on its own, as in the plain PyTorch versions the
// kernels are held against.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace npswf {

constexpr int kBlock = 128;  // threads per block of the thread-per-lane kernels

// dtype codes passed from the ctypes wrappers
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

// max that propagates NaN, as jnp.max / torch.amax do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b || b > a) return b;
  return a;
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a) return a;
  if (b != b || b < a) return b;
  return a;
}

// clip(x, lo, hi) = min(max(x, lo), hi) with NaN passing through
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nan_min(nan_max(x, lo), hi);
}

}  // namespace npswf

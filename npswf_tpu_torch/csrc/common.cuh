// Shared helpers for the port's hand-written kernels.
//
// A lane is one event x block waveform. K1 runs a block a tile of lanes,
// one thread a (lane, output bin); K2/K4 (search.cu) and K3 (lm.cu) run a
// team of threads per lane (K2/K4 a tile of lanes a block, K3 one warp a
// block); K5-K7 run one thread per lane (K5 one per lane and fit bin).
// Every kernel is compiled with -fmad=false: each multiply and add rounds on
// its own, as in the plain PyTorch versions the kernels are held against.
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

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// The block copies `count` contiguous values from device memory to
// put(i, value): 16-byte loads where `g` is 16-byte aligned, neighbouring
// threads on neighbouring addresses.
template <typename T, typename Put>
__device__ __forceinline__ void load_span(const T* __restrict__ g, int count,
                                          Put put) {
  constexpr int kv = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    using V = typename Vec16<T>::type;
    const V* gv = reinterpret_cast<const V*>(g);
    const int nv = count / kv;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const V v = gv[i];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < kv; ++j) put(i * kv + j, e[j]);
    }
    done = nv * kv;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) put(i, g[i]);
}

// Raise a kernel's dynamic shared memory limit to `bytes` when that is above
// the default 48 KB, on the current device and at every launch (the
// attribute is per device, and setting it is cheap); fails when the card
// has less to give.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace npswf

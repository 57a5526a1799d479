// Shared helpers for the port's hand-written kernels.
//
// A lane is one event x block waveform. K1 runs a block a tile of lanes,
// one thread a (lane, output bin); K2/K4 (search.cu) and K3 (lm.cuh) run a
// team of threads per lane (K2/K4 a tile of lanes a block, K3 one warp a
// block); K5 runs one thread per lane and fit bin; K6/K7 (eval.cu) a tile
// of lanes a block, one thread a (lane, bin), then one owner thread a block
// of sums.
// Every kernel is compiled with -fmad=false: each multiply and add rounds on
// its own, as in the plain PyTorch versions the kernels are held against.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace npswf {

constexpr int kBlock = 128;  // threads per block of K5

// dtype codes passed from the ctypes wrappers
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;

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

// Asynchronous copies from device to shared memory (cp.async): a thread
// issues all of its copies before it waits for any, so the block keeps
// many loads in flight. N = 4, 8 or 16 bytes; wait with cp_async_wait_all()
// and then __syncthreads().
template <int N>
__device__ __forceinline__ void cp_async(void* s, const void* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
               "l"(g), "n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block copies ``count`` contiguous values from g to s: 16 bytes a copy
// where g and s are equally aligned, neighbouring threads on neighbouring
// addresses, single values at the ends (or throughout when they are not).
template <typename T>
__device__ __forceinline__ void copy_span_async(T* s, const T* g, int count) {
  constexpr int kv = 16 / sizeof(T);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  int head = count, nv = 0;
  if (((ga ^ sa) & 15) == 0) {
    head = min(count, (int)(((16 - (ga & 15)) & 15) / sizeof(T)));
    nv = (count - head) / kv;
  }
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async<16>(s + head + i * kv, g + head + i * kv);
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    cp_async<sizeof(T)>(s + i, g + i);
  for (int i = head + nv * kv + threadIdx.x; i < count; i += blockDim.x)
    cp_async<sizeof(T)>(s + i, g + i);
}

// ``rows`` rows of k values, ``ld`` values apart in device memory, to
// s [rows, k]: one span when they are contiguous, else value by value.
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* s, const T* g, long long ld,
                                                int rows, int k) {
  if (ld == k) {
    copy_span_async(s, g, rows * k);
    return;
  }
  for (int i = threadIdx.x; i < rows * k; i += blockDim.x) {
    const int r = i / k;
    cp_async<sizeof(T)>(s + i, g + r * ld + (i - r * k));
  }
}

// The shared memory a block of the current device may opt in to.
inline size_t smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)v;
}

// Raise a kernel's dynamic shared memory limit to `bytes` when that is above
// the default 48 KB, on the current device and at every launch (the
// attribute is per device, and setting it is cheap); fails when the card
// has less to give.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > smem_optin()) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace npswf

// K1: batched matched filter, a tile of lanes a block.
//
// Replaces npswf_tpu/ops/pallas_kernels.py::_mf_kernel (wrapper
// matched_filter_pallas). Per lane: subtract the baseline, run the W-tap
// correlation with the per-tap divide by mfint in ascending tap order
// (acc += (delta*kern)/mfint, ref TEST_2.C:158-161), subtract the window
// minimum and zero the bins outside [lo, hi).
//
// What bounds it on the card: device memory. Per lane it reads T + W + 2
// values and writes T; at N = 69,120 lanes, T = 110 and W = 11 the call
// moves 64.4 MB (fp32), 0.0192 ms at 3.35 TB/s. The arithmetic is W
// divisions and 3*W other operations an output bin, and the divisions
// cost the most: the compiler's IEEE fp32 division is a reciprocal
// estimate, five fused multiply-adds and a range check with a branch to a
// slow path, which splits every tap into its own block of code.
// What the design does about it: a block takes kMfLanes lanes, whose
// signal and kernel rows are contiguous spans: it copies them to shared
// memory with 16-byte loads. Each thread then computes output bins of the
// tile (bin i of the flat [lanes, T] tile to thread i % blockDim), the taps
// in order, into shared memory; one thread a lane takes the window minimum
// in bin order; the tile is written back as one contiguous span, neighbour
// threads on neighbouring addresses. At fp32 each tap divides through the
// lane's fp64 reciprocal (fp32_div), exactly as IEEE fp32 division rounds,
// with no branch in the tap loop. Compiled with -fmad=false so that the
// kernel is bit-equal to the plain PyTorch version (ops/matched_filter.py),
// which rounds each op separately.
#include "common.cuh"

namespace npswf {

constexpr int kMfLanes = 16;   // lanes a block
constexpr int kMfBlock = 128;  // threads a block

inline size_t mf_smem(int nt, int w, size_t elem) {
  return sizeof(double) * kMfLanes +
         elem * ((size_t)kMfLanes * (2 * nt + w) + 3 * kMfLanes);
}

// a / b as IEEE fp32 division rounds it, from rcp = 1.0 / (double)b. The
// fp64 product q = a * rcp is within 2^-52 (relative) of a / b, and an
// fp32 quotient of normal size is never a rounding tie and lies at least
// 2^-49 from every tie (a tie has a 25-bit odd significand, which a
// quotient of two 24-bit significands cannot equal or come nearer to), so
// rounding q to fp32 gives the IEEE quotient; zeros, infinities and NaNs
// follow IEEE too. Below 2^-126 a quotient can be a tie, so `tiny` flags
// those and the caller divides again with '/'.
__device__ __forceinline__ float fp32_div(float a, double rcp, bool& tiny) {
  const double q = (double)a * rcp;
  tiny = tiny | ((fabs(q) < 0x1p-126) & (q != 0.0));
  return (float)q;
}

template <typename T>
__global__ void __launch_bounds__(kMfBlock)
mf_kernel(const T* __restrict__ sig, const T* __restrict__ mins,
          const T* __restrict__ kern, const T* __restrict__ mfint,
          T* __restrict__ out, int n, int nt, int w, int lo, int hi, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_rcp = reinterpret_cast<double*>(smem_raw);  // [kMfLanes]
  T* s_sig = reinterpret_cast<T*>(s_rcp + kMfLanes);    // [kMfLanes, nt]
  T* s_acc = s_sig + kMfLanes * nt;                     // [kMfLanes, nt]
  T* s_kern = s_acc + kMfLanes * nt;                    // [kMfLanes, w]
  T* s_mn = s_kern + kMfLanes * w;                      // [kMfLanes]
  T* s_inv = s_mn + kMfLanes;                           // [kMfLanes]
  T* s_min = s_inv + kMfLanes;                          // [kMfLanes]
  const int lane0 = blockIdx.x * kMfLanes;
  const int nl = min(kMfLanes, n - lane0);
  const int span = nl * nt;
  load_span(sig + (size_t)lane0 * nt, span, [&](int i, T v) { s_sig[i] = v; });
  load_span(kern + (size_t)lane0 * w, nl * w, [&](int i, T v) { s_kern[i] = v; });
  if (threadIdx.x < nl) {
    s_mn[threadIdx.x] = mins[lane0 + threadIdx.x];
    s_inv[threadIdx.x] = mfint[lane0 + threadIdx.x];
    s_rcp[threadIdx.x] = 1.0 / (double)mfint[lane0 + threadIdx.x];
  }
  __syncthreads();

  // bin i of the tile is lane k, bin it; stepping by blockDim.x (< nt when
  // nt >= 128, else a few wraps) keeps k and it without a division a bin
  int k = threadIdx.x / nt, it = threadIdx.x % nt;
  const int step_k = blockDim.x / nt, step_t = blockDim.x % nt;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    if (it >= lo && it < hi) {
      const T* s = s_sig + k * nt;
      const T* kk = s_kern + k * w;
      const T mn = s_mn[k], inv = s_inv[k];
      // window position it reads sample it + jt - mfright (ref :158)
      T acc = T(0);
      bool tiny = false;
      if constexpr (sizeof(T) == 4) {
        const double rcp = s_rcp[k];
        for (int jt = 0; jt < w; ++jt)
          acc = acc + fp32_div((s[it + jt - r] - mn) * kk[jt], rcp, tiny);
      }
      if (sizeof(T) == 8 || tiny) {
        acc = T(0);
        for (int jt = 0; jt < w; ++jt) {
          const T delta = s[it + jt - r] - mn;
          acc = acc + (delta * kk[jt]) / inv;
        }
      }
      s_acc[i] = acc;
    }
    k += step_k;
    it += step_t;
    if (it >= nt) {
      it -= nt;
      ++k;
    }
  }
  __syncthreads();
  if (threadIdx.x < nl && lo < hi) {
    const T* a = s_acc + threadIdx.x * nt;
    T mfmin = a[lo];
    for (int j = lo + 1; j < hi; ++j) mfmin = nan_min(mfmin, a[j]);
    s_min[threadIdx.x] = mfmin;
  }
  __syncthreads();
  T* o = out + (size_t)lane0 * nt;
  k = threadIdx.x / nt;
  it = threadIdx.x % nt;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    o[i] = (it >= lo && it < hi) ? s_acc[i] - s_min[k] : T(0);
    k += step_k;
    it += step_t;
    if (it >= nt) {
      it -= nt;
      ++k;
    }
  }
}

template <typename T>
static cudaError_t launch(const void* sig, const void* mins, const void* kern,
                          const void* mfint, void* out, int n, int nt, int w,
                          int lo, int hi, int r, cudaStream_t st) {
  const size_t smem = mf_smem(nt, w, sizeof(T));
  const cudaError_t e = allow_smem(mf_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  mf_kernel<T><<<(n + kMfLanes - 1) / kMfLanes, kMfBlock, smem, st>>>(
      (const T*)sig, (const T*)mins, (const T*)kern, (const T*)mfint, (T*)out,
      n, nt, w, lo, hi, r);
  return cudaGetLastError();
}

}  // namespace npswf

extern "C" int npswf_matched_filter(int dtype, const void* sig,
                                    const void* mins, const void* kern,
                                    const void* mfint, void* out, int n,
                                    int nt, int w, int lo, int hi, int r,
                                    void* stream) {
  if (n < 1 || nt < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == npswf::kFloat32
                   ? npswf::launch<float>(sig, mins, kern, mfint, out, n, nt,
                                          w, lo, hi, r, st)
                   : npswf::launch<double>(sig, mins, kern, mfint, out, n, nt,
                                           w, lo, hi, r, st));
}

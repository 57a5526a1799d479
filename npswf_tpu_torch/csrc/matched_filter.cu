// K1: batched matched filter, one thread per lane.
//
// Replaces npswf_tpu/ops/pallas_kernels.py::_mf_kernel (wrapper
// matched_filter_pallas). Per lane: subtract the baseline, run the W-tap
// correlation with the per-tap divide by mfint in ascending tap order
// (acc += (delta*kern)/mfint, ref TEST_2.C:158-161), subtract the window
// minimum and zero the bins outside [lo, hi).
//
// What bounds it on the card: device memory. Per lane it reads T + W + 2
// values and writes T, with 2*W flops per output bin; at N = 69,120 lanes
// and T = 110 the whole call moves about 60 MB (fp32).
// What the design does about it: one pass over the signal, the correlation
// and the window minimum kept in registers; the output row is written once
// and then re-read from L1 for the minimum subtraction. Compiled with
// -fmad=false and IEEE division so that it is bit-equal to the plain
// PyTorch version (ops/matched_filter.py), which rounds each op separately.
#include "common.cuh"

namespace npswf {

template <typename T>
__global__ void __launch_bounds__(kBlock)
mf_kernel(const T* __restrict__ sig, const T* __restrict__ mins,
          const T* __restrict__ kern, const T* __restrict__ mfint,
          T* __restrict__ out, int n, int nt, int w, int lo, int hi, int r) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const T* s = sig + (size_t)lane * nt;
  const T* k = kern + (size_t)lane * w;
  T* o = out + (size_t)lane * nt;
  const T mn = mins[lane];
  const T inv = mfint[lane];
  T mfmin = T(0);
  for (int it = lo; it < hi; ++it) {
    T acc = T(0);
    for (int jt = 0; jt < w; ++jt) {
      // window position it reads sample it + jt - mfright (ref :158)
      const T delta = s[it + jt - r] - mn;
      acc = acc + (delta * k[jt]) / inv;
    }
    o[it] = acc;
    mfmin = (it == lo) ? acc : nan_min(mfmin, acc);
  }
  for (int it = 0; it < lo; ++it) o[it] = T(0);
  for (int it = lo; it < hi; ++it) o[it] = o[it] - mfmin;
  for (int it = hi; it < nt; ++it) o[it] = T(0);
}

template <typename T>
static void launch(const void* sig, const void* mins, const void* kern,
                   const void* mfint, void* out, int n, int nt, int w, int lo,
                   int hi, int r, cudaStream_t st) {
  mf_kernel<T><<<grid_for(n), kBlock, 0, st>>>(
      (const T*)sig, (const T*)mins, (const T*)kern, (const T*)mfint, (T*)out,
      n, nt, w, lo, hi, r);
}

}  // namespace npswf

extern "C" int npswf_matched_filter(int dtype, const void* sig,
                                    const void* mins, const void* kern,
                                    const void* mfint, void* out, int n,
                                    int nt, int w, int lo, int hi, int r,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == npswf::kFloat32)
    npswf::launch<float>(sig, mins, kern, mfint, out, n, nt, w, lo, hi, r, st);
  else
    npswf::launch<double>(sig, mins, kern, mfint, out, n, nt, w, lo, hi, r, st);
  return (int)cudaGetLastError();
}

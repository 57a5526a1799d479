// K2 and K4: the whole TSpectrum-parity peak search up to the four sort
// operands (K2) or up to their top-P slots (K4), one thread per lane.
//
// Replaces npswf_tpu/ops/pallas_search.py::_search_kernel in operands mode
// (K2, wrapper search_operands_pallas, select_p = 0) and in select mode
// (K4, wrapper search_topk_pallas, select_p = P). Per lane, over the
// extended frame of size_ext = T + 2*shift bins:
//   1. extension: straight-line left extrapolation (clamped at 0) and a
//      constant right edge;
//   2. log-space Markov smoothing over +-aver_window neighbours, with the
//      cumulative sum run sequentially in cumsum order;
//   3. Gold deconvolution against the quantized Gaussian response
//      (lh_gold-tap and (2*lh_gold-1)-tap correlations, stale-value
//      buffering), shifted by the response maximum;
//   4. local-max acceptance against specthres * max, 3-bin centroid;
//   5. the four sort operands in the source-bin frame: negkey (+inf on
//      rejected bins), centroid, pos_y at the rounded centroid and the aux
//      spectrum at round(centroid) + aux_offset;
//   6. select mode only: P rounds of "smallest negkey, smallest bin on
//      ties", masking the bin taken, written as [P, N] slots -- the first P
//      entries of the stable sort that follows K2, with no sort.
// The semantics are those of the XLA path, npswf_tpu/ops/peak_search.py:
// 124-297, which the plain PyTorch version in ops/peak_search.py follows.
//
// What bounds it on the card: device memory. Each lane keeps seven working
// spectra of R = size_ext + 32 bins in a scratch tensor (about 5 KB a lane
// in fp32) and walks them a few times; the arithmetic (exp, log, sqrt and
// ~40 multiply-adds a bin) is small beside that traffic.
// What the design does about it: the scratch is laid out lanes-minor,
// [buffer][row][lane], so that the 32 threads of a warp touching the same
// row hit 32 neighbouring addresses (coalesced). The input and output
// spectra are [T, N] ([P, N] in select mode) for the same reason. K4 reads
// the same inputs as K2 and writes P rows instead of T: its bound at P = 12
// is 2 x 30.4 MB in and 4 x 3.3 MB out in fp32 (74 MB); the selection
// re-reads the lane's four operand rows from its scratch, P x T loads. Each spectrum row has 16-row
// margins: zeros for the Gold correlations, copies of the edge values for
// the Markov neighbours, so no inner loop tests its bounds. The margins
// bound the Gold reach lh_gold - 1 and the Markov window to 16; the
// wrapper refuses wider settings.
#include "common.cuh"

namespace npswf {

constexpr int kMarg = 16;
enum Buf { kExt = 0, kY, kLogw, kSabs, kPvec, kXa, kXb, kNumBuf };

struct SearchParams {
  int ssize, shift, size_ext, kfit, lh_gold, posit, aver_window, iters,
      aux_offset, select_p;
  double m0, m1, det, area, specthres;
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
search_kernel(const T* __restrict__ src, const T* __restrict__ aux,
              const T* __restrict__ resp, const T* __restrict__ bvec,
              T* __restrict__ scratch, T* __restrict__ negkey,
              T* __restrict__ cent, T* __restrict__ posy,
              T* __restrict__ auxsel, SearchParams p, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int ssize = p.ssize, shift = p.shift, size_ext = p.size_ext;
  const int xmax = size_ext - 1;
  const int L = p.lh_gold - 1;
  const int R = size_ext + 2 * kMarg;
  // frame row e of buffer b (e may reach into the +-kMarg margins)
  auto at = [&](int b, int e) -> T& {
    return scratch[((size_t)b * R + (e + kMarg)) * n + lane];
  };
  auto s_at = [&](int t) -> T { return src[(size_t)t * n + lane]; };
  // the source spectrum placed in the extended frame, zero outside
  auto pad_src = [&](int q) -> T {
    return (q >= shift && q < shift + ssize) ? s_at(q - shift) : T(0);
  };
  auto pad_aux = [&](int q) -> T {
    return (q >= shift && q < shift + ssize) ? aux[(size_t)(q - shift) * n + lane]
                                             : T(0);
  };

  // ---- 1. extension ------------------------------------------------
  T l1low = T(0);
  if (p.kfit >= 2) {
    T l0 = T(0), l1 = T(0);
    for (int i = 0; i < p.kfit; ++i) {
      l0 = l0 + s_at(i);
      l1 = l1 + s_at(i) * T(i);
    }
    l1low = (p.det != 0.0) ? (-l0 * T(p.m1) + l1 * T(p.m0)) / T(p.det) : T(0);
    l1low = nan_min(l1low, T(0));
  }
  const T src0 = s_at(0);
  const T right = nan_max(s_at(ssize - 1), T(0));
  T maxch = T(0), plocha = T(0);
  for (int e = 0; e < size_ext; ++e) {
    T v;
    if (e < shift)
      v = nan_max(src0 + l1low * T(e - shift), T(0));
    else if (e < shift + ssize)
      v = s_at(e - shift);
    else
      v = right;
    at(kExt, e) = v;
    maxch = (e == 0) ? v : nan_max(maxch, v);
    plocha = plocha + v;
  }

  // ---- 2. Markov smoothing (log space, scale-invariant) ------------
  const T safe = maxch > T(0) ? maxch : T(1);
  for (int e = 0; e < size_ext; ++e) at(kY, e) = at(kExt, e) / safe;
  {
    const T y0 = at(kY, 0), yx = at(kY, xmax);
    for (int m = 1; m <= kMarg; ++m) {
      at(kY, -m) = y0;        // y[max(i-l+1, 0)]
      at(kY, xmax + m) = yx;  // y[min(i+l, xmax)]
    }
  }
  T logw = T(0);
  T wmaxl = T(0);
  at(kLogw, 0) = T(0);
  for (int i = 0; i < xmax; ++i) {
    const T nip = at(kY, i), nim = at(kY, i + 1);
    T sp = T(0), sm = T(0);
    for (int l = 1; l <= p.aver_window; ++l) {
      const T a_f = at(kY, i + l);
      const T sf = a_f + nip;
      const T den_f = (sf <= T(0)) ? T(1) : sqrt(sf);
      sp = sp + exp((a_f - nip) / den_f);
      const T a_b = at(kY, i - l + 1);
      const T sb = a_b + nim;
      const T den_b = (sb <= T(0)) ? T(1) : sqrt(sb);
      sm = sm + exp((a_b - nim) / den_b);
    }
    logw = logw + (log(sp) - log(sm));  // sequential cumsum
    at(kLogw, i + 1) = logw;
    wmaxl = nan_max(wmaxl, logw);
  }
  T sumw = T(0);
  for (int e = 0; e < size_ext; ++e) {
    const T w = exp(at(kLogw, e) - wmaxl);
    at(kLogw, e) = w;
    sumw = sumw + w;
  }
  for (int m = 1; m <= kMarg; ++m) {
    at(kSabs, -m) = T(0);
    at(kSabs, xmax + m) = T(0);
    at(kXa, -m) = T(0);
    at(kXa, xmax + m) = T(0);
    at(kXb, -m) = T(0);
    at(kXb, xmax + m) = T(0);
  }
  for (int e = 0; e < size_ext; ++e) {
    at(kSabs, e) = fabs(at(kLogw, e) / sumw * plocha);
    at(kXa, e) = T(1);
  }

  // ---- 3. Gold deconvolution ---------------------------------------
  for (int e = 0; e < size_ext; ++e) {
    T pv = T(0);
    for (int j = 0; j < p.lh_gold; ++j) pv = pv + resp[j] * at(kSabs, e - L + j);
    at(kPvec, e) = pv;
  }
  int cur = kXa, nxt = kXb;
  for (int it = 0; it < p.iters; ++it) {
    for (int e = 0; e < size_ext; ++e) {
      T den = T(0);
      for (int j = 0; j <= 2 * L; ++j) den = den + bvec[j] * at(cur, e - L + j);
      const T pv = at(kPvec, e), xv = at(cur, e);
      const bool cond = fabs(pv) > T(1e-5) && fabs(xv) > T(1e-5);
      const T factor = (den != T(0) && pv != T(0)) ? pv / den : T(0);
      // JAX keeps `prev` = the previous iterate (zeros before the first)
      at(nxt, e) = cond ? factor * xv : (it == 0 ? T(0) : xv);
    }
    const int t = cur;
    cur = nxt;
    nxt = t;
  }
  const T area = T(p.area);
  auto in_range = [&](int e) {
    return e >= shift && e < ssize + shift && e < size_ext - L;
  };
  // decon[e] = area * x[e - (posit - L)] (circular), zero off the range
  auto decon = [&](int e) -> T {
    if (!in_range(e)) return T(0);
    int q = (e - (p.posit - L)) % size_ext;
    if (q < 0) q += size_ext;
    return area * at(cur, q);
  };
  T max_decon = T(0);
  T maximum = -INFINITY;
  for (int e = 0; e < size_ext; ++e) {
    max_decon = (e == 0) ? decon(e) : nan_max(max_decon, decon(e));
    if (in_range(e)) maximum = nan_max(maximum, at(kExt, e));
  }

  // ---- 4./5. accept, centroid, window selects, sort operands -------
  const T rel = T(p.specthres);
  const T thr_decon = rel * max_decon;
  const T thr_src = T(p.specthres) * maximum;
  int cmin = p.aux_offset - 1 < 0 ? p.aux_offset - 1 : 0;
  int cmax = p.aux_offset + 1 > 0 ? p.aux_offset + 1 : 0;
  for (int t = 0; t < ssize; ++t) {
    const int e = t + shift;
    const T d0 = decon(e - 1), d1 = decon(e), d2 = decon(e + 1);
    const bool is_lmax = e >= 1 && e <= xmax - 1 && d1 > d0 && d1 > d2;
    const bool accept = is_lmax && in_range(e) && d1 > thr_decon &&
                        at(kExt, e) > thr_src && maxch > T(0);
    const T num = (T(e - 1 - shift) * d0 + T(e - shift) * d1) +
                  T(e + 1 - shift) * d2;
    const T den3 = (d0 + d1) + d2;
    const T a = clip(num / (den3 == T(0) ? T(1) : den3), T(0), T(ssize - 1));
    const int a_int = min(max((int)floor(a), 0), ssize - 1);
    const int k_round = min(max((int)floor(a + T(0.5)), 0), ssize - 1);
    // window select: arr[target] when the target lies within the
    // candidate offsets of this bin, else arr[e] (the XLA path's
    // shifted-slice selects)
    const int kk = a_int + shift;
    const T key = (kk - e >= -1 && kk - e <= 1) ? pad_src(kk) : pad_src(e);
    const int kr = k_round + shift;
    const T py = (kr - e >= -1 && kr - e <= 1) ? pad_src(kr) : pad_src(e);
    const int tgt = min(max(k_round + p.aux_offset, 0), ssize - 1) + shift;
    const T ax = (tgt - e >= cmin && tgt - e <= cmax) ? pad_aux(tgt) : pad_aux(e);
    const T nk = accept ? -key : T(INFINITY);
    if (p.select_p == 0) {
      const size_t o = (size_t)t * n + lane;
      negkey[o] = nk;
      cent[o] = a;
      posy[o] = py;
      auxsel[o] = ax;
    } else {
      // the Markov and Gold buffers are free now: keep the operands there
      at(kY, t) = nk;
      at(kLogw, t) = a;
      at(kSabs, t) = py;
      at(kPvec, t) = ax;
    }
  }
  if (p.select_p == 0) return;

  // ---- 6. top-P selection (select mode) ----------------------------
  // P rounds: the smallest negkey, the smallest bin among equal keys (the
  // strict < keeps the first), then that bin is masked -- the first P
  // entries of a stable ascending sort on negkey. NaN keys are never taken
  // (a sort puts them last); slots past the accepted count get +inf.
  for (int q = 0; q < p.select_p; ++q) {
    T best = T(INFINITY);
    int hit = -1;
    for (int t = 0; t < ssize; ++t) {
      const T v = at(kY, t);
      if (v < best) {
        best = v;
        hit = t;
      }
    }
    const size_t o = (size_t)q * n + lane;
    negkey[o] = best;
    cent[o] = hit < 0 ? T(0) : at(kLogw, hit);
    posy[o] = hit < 0 ? T(0) : at(kSabs, hit);
    auxsel[o] = hit < 0 ? T(0) : at(kPvec, hit);
    if (hit >= 0) at(kY, hit) = T(INFINITY);
  }
}

template <typename T>
static void launch(const void* src, const void* aux, const void* resp,
                   const void* bvec, void* scratch, void* negkey, void* cent,
                   void* posy, void* auxsel, const SearchParams& p, int n,
                   cudaStream_t st) {
  search_kernel<T><<<grid_for(n), kBlock, 0, st>>>(
      (const T*)src, (const T*)aux, (const T*)resp, (const T*)bvec,
      (T*)scratch, (T*)negkey, (T*)cent, (T*)posy, (T*)auxsel, p, n);
}

}  // namespace npswf

extern "C" int npswf_search_scratch_rows(int size_ext) {
  return npswf::kNumBuf * (size_ext + 2 * npswf::kMarg);
}

// select_p = 0: the four operands, each [T, N]; select_p = P > 0: the
// first P slots of their stable sort on negkey, each [P, N].
extern "C" int npswf_search(
    int dtype, const void* src, const void* aux, const void* resp,
    const void* bvec, void* scratch, void* negkey, void* cent, void* posy,
    void* auxsel, int n, int ssize, int shift, int kfit, int lh_gold,
    int posit, int aver_window, int iters, int aux_offset, int select_p,
    double m0, double m1, double det, double area, double specthres,
    void* stream) {
  npswf::SearchParams p;
  p.ssize = ssize;
  p.shift = shift;
  p.size_ext = ssize + 2 * shift;
  p.kfit = kfit;
  p.lh_gold = lh_gold;
  p.posit = posit;
  p.aver_window = aver_window;
  p.iters = iters;
  p.aux_offset = aux_offset;
  p.select_p = select_p;
  p.m0 = m0;
  p.m1 = m1;
  p.det = det;
  p.area = area;
  p.specthres = specthres;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == npswf::kFloat32)
    npswf::launch<float>(src, aux, resp, bvec, scratch, negkey, cent, posy,
                         auxsel, p, n, st);
  else
    npswf::launch<double>(src, aux, resp, bvec, scratch, negkey, cent, posy,
                          auxsel, p, n, st);
  return (int)cudaGetLastError();
}

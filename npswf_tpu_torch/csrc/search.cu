// K2 and K4: the whole TSpectrum-parity peak search up to the four sort
// operands (K2) or up to their top-P slots (K4), a team of threads per
// lane.
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
//   6. select mode only: the first P entries of the stable sort on negkey
//      that follows K2, one a round ("smallest key, smallest bin on
//      ties", the bin taken then flagged), with no sort.
// The semantics are those of the XLA path, npswf_tpu/ops/peak_search.py:
// 124-297, which the plain PyTorch version in ops/peak_search.py follows.
//
// What bounds it on the card: device memory, 2 x [N, T] in and 4 x [N, T]
// out (0.0545 ms at N = 69,120, T = 110, fp32), if the working spectra stay
// on the chip; K4 at P = 12 is bound by its operations. Per lane the work
// is a chain of dependent phases (a few thousand instructions of exp, log,
// sqrt, IEEE division and ~40 taps a bin).
// What the design does about it:
//   - a block takes a tile of lanes, whose rows of src and aux are one
//     contiguous span each: the block copies them to shared memory with
//     16-byte loads, and each team stores its lane's operand rows, bins on
//     neighbouring threads, into contiguous [N, T] ([N, P]) outputs: no
//     transpose before or after;
//   - a team of kTeam = 16 threads works each lane (8 and 32 were timed
//     too and were slower, PERF.md), and the lane's working spectra live
//     in shared memory: three frames of size_ext + 2*marg (+ slack) values
//     (ext, then sabs, then the second Gold iterate; y, then the first Gold
//     iterate; logr and w, then pvec, then decon), 2.2 KB a lane at fp32
//     and the default sigma = 2 beside its 0.9 KB of src and aux. No global
//     scratch;
//   - the phases that are independent per bin (extension, y, the Markov
//     terms, w, sabs, pvec, each Gold iteration into the other buffer,
//     decon and the operands) are split over the team, bin e to thread
//     e % kTeam (the tap sums: chunks of kChunk bins, a sliding window of
//     the spectrum in registers), with a team sync between phases;
//   - every sum the plain version runs column by column keeps one owner
//     thread that adds it up in bin order from zero (plocha, the logr
//     cumsum, sumw; l0/l1 every thread computes alike); the owners of a
//     tile's lanes sit side by side in the block's first warp, so the
//     serial sums cost one warp's issue slots a block, not one a lane.
//     Each per-bin tap sum stays in tap order. Maxima reduce as a tree of
//     NaN-propagating max, which is exact; select mode reduces (kind,
//     negkey, bin) the same way;
//   - two shortcuts that leave every rounding as it was: the Markov
//     backward term at l = 1 divides the forward term's numerator negated
//     by the same square root, so it is computed once and negated; the
//     first Gold iterate is 1 on the frame and 0 on its margins, so its
//     denominators add up the taps that land on the frame (adding a zero
//     product changes no sum);
//   - exp, log, sqrt and IEEE division, no fast intrinsics, -fmad=false:
//     every value is bit-equal to the plain PyTorch version.
// Each frame has marg-row margins: zeros for the Gold correlations,
// copies of the edge values for the Markov neighbours, so no inner loop
// tests its bounds. marg is set at run time to hold the Gold reach
// lh_gold - 1 and the Markov window: 16 rows up to 16 (the default
// sigma = 2 and window 3 need 13 and 3), else the larger rounded up to a
// multiple of 8. The taps (resp, then bvec, in the working type) come from
// a device buffer the wrapper fills once a setting, and the block stages
// them beside its rows. The frames grow with the reach and the window, so
// the lanes a block (plan_search) drop from kLanes (every default setting
// keeps the layout tuned for it) one by one to 1 as they do. Only a setting whose
// one lane does not fit a block's shared memory is refused: at T = 110 on
// a card with 227 KB a block, a sigma above 277 in fp64 (561 in fp32), or
// a window above 4,720 bins at sigma 2 (9,560).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace npswf {

constexpr int kMargMin = 16;             // the narrowest frame margin
constexpr int kSearchBlock = 128;        // threads of a block of kLanes
constexpr int kScalars = 4;              // a lane's broadcast values
constexpr int kTeam = 16;                // threads a lane
constexpr int kLanes = kSearchBlock / kTeam;  // the most lanes a block

// lanes: lanes a block (kLanes down to 1)
struct SearchParams {
  int ssize, shift, size_ext, marg, kfit, lh_gold, posit, aver_window, iters,
      aux_offset, select_p, lanes;
  double m0, m1, det, area, specthres;
};

// Bins a thread takes at once in the tap sums (pvec, the Gold
// denominators): with size_ext = 138, one round of chunks for the team.
constexpr int kChunk = 9;

// The frame margin of a Gold reach L = lh_gold - 1 and a Markov window.
inline int search_margin(int L, int aver_window) {
  const int m = L > aver_window ? L : aver_window;
  return m <= kMargMin ? kMargMin : (m + 7) / 8 * 8;
}

// Shared memory of a block: the taps (rounded up to 4 values), the tile's
// src and aux rows, then one region a lane (three frames and the broadcast
// scalars), its stride padded so that the teams sharing a warp start on
// different banks. A frame holds rows -marg .. size_ext + marg - 1 and
// kChunk rows of slack that the last chunk's tap sums read and never use.
__host__ __device__ inline int taps_len(int lh_gold) {
  return (3 * lh_gold - 1 + 3) / 4 * 4;
}
__host__ __device__ inline int frame_rows(int size_ext, int marg) {
  return size_ext + 2 * marg + kChunk;
}
__host__ __device__ inline int lane_stride(int size_ext, int marg) {
  const int base = 3 * frame_rows(size_ext, marg) + kScalars;
  return base + (kTeam - base % 32 + 32) % 32;
}
static size_t search_smem_bytes(size_t tsize, int ssize, int size_ext,
                                int marg, int lh_gold, int lanes) {
  return tsize * ((size_t)taps_len(lh_gold) + 2 * (size_t)lanes * ssize +
                  (size_t)lanes * lane_stride(size_ext, marg));
}

// The lanes a block at this margin (kLanes, then as many as fit as the
// frames grow, so that a block keeps as much of an SM's shared memory in
// use as it can; 0 where not even one lane's fit) and its shared memory.
static int plan_search(size_t tsize, int ssize, int size_ext, int marg,
                       int lh_gold, size_t& smem) {
  for (int lanes = kLanes; lanes >= 1; --lanes) {
    smem = search_smem_bytes(tsize, ssize, size_ext, marg, lh_gold, lanes);
    if (smem <= smem_optin()) return lanes;
  }
  smem = 0;
  return 0;
}

template <typename T, typename Team>
__device__ __forceinline__ T team_max(const Team& team, T v) {
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1) v = nan_max(v, team.shfl_xor(v, o));
  return team.shfl(v, 0);  // one value for the whole team (+-0, NaN payloads)
}

// acc[b] = the sum over j = 0, 1, ..., ntaps - 1, in that order, of
// taps[j] * x[e0 + b + j], for the C bins e0 .. e0 + C - 1: each tap loads
// one new value of x into a sliding window (and one past the last tap).
template <int C, typename T>
__device__ __forceinline__ void tap_sums(const T* x, const T* taps, int ntaps,
                                         int e0, T (&acc)[C]) {
  T win[C];
#pragma unroll
  for (int b = 0; b < C; ++b) {
    acc[b] = T(0);
    win[b] = x[e0 + b];
  }
  for (int j = 0; j < ntaps; ++j) {
    const T tj = taps[j];
#pragma unroll
    for (int b = 0; b < C; ++b) acc[b] = acc[b] + tj * win[b];
#pragma unroll
    for (int b = 0; b + 1 < C; ++b) win[b] = win[b + 1];
    win[C - 1] = x[e0 + C + j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kSearchBlock)
search_kernel(const T* __restrict__ src, const T* __restrict__ aux,
              const T* __restrict__ taps,
              T* __restrict__ negkey, T* __restrict__ cent,
              T* __restrict__ posy, T* __restrict__ auxsel,
              const SearchParams p, int n) {
  constexpr int C = kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ssize = p.ssize, shift = p.shift, size_ext = p.size_ext;
  const int xmax = size_ext - 1;
  const int L = p.lh_gold - 1;
  const int marg = p.marg;
  const int R = frame_rows(size_ext, marg);
  const int stride = lane_stride(size_ext, marg);
  const int lanes = p.lanes;
  T* s_resp = reinterpret_cast<T*>(smem_raw);  // [lh_gold]
  T* s_bvec = s_resp + p.lh_gold;              // [2 * lh_gold - 1]
  T* s_src = s_resp + taps_len(p.lh_gold);     // [lanes, T]
  T* s_aux = s_src + lanes * ssize;            // [lanes, T]
  T* s_lane = s_aux + lanes * ssize;           // [lanes, stride]

  const int lane0 = blockIdx.x * lanes;
  const int nl = min(lanes, n - lane0);
  for (int j = threadIdx.x; j < 3 * p.lh_gold - 1; j += blockDim.x) s_resp[j] = taps[j];
  load_span(src + (size_t)lane0 * ssize, nl * ssize, [&](int i, T v) { s_src[i] = v; });
  load_span(aux + (size_t)lane0 * ssize, nl * ssize, [&](int i, T v) { s_aux[i] = v; });
  __syncthreads();

  auto team = cg::tiled_partition<kTeam>(cg::this_thread_block());
  const int k = threadIdx.x / kTeam;  // the team's lane in the tile
  const bool live = k < nl;          // teams past a short tile's lanes idle
  const int tr = team.thread_rank();
  const int lane = lane0 + k;
  const T* s = s_src + k * ssize;
  const T* ax = s_aux + k * ssize;
  // frame row e of a buffer, -marg <= e < size_ext + marg + C
  auto frame = [&](int kk, int b) {
    return s_lane + (size_t)kk * stride + marg + b * R;
  };
  T* const b0 = frame(k, 0);
  T* const b1 = frame(k, 1);
  T* const b2 = frame(k, 2);
  T* const sc = b2 + R - marg;  // [kScalars]

  T maxch = T(0), plocha = T(0);
  if (live) {
    // ---- 1. extension (every thread computes l1low alike) -------------
    T l1low = T(0);
    if (p.kfit >= 2) {
      T l0 = T(0), l1 = T(0);
      const int nfit = min(p.kfit, ssize);  // the bins that exist
      for (int i = 0; i < nfit; ++i) {
        l0 = l0 + s[i];
        l1 = l1 + s[i] * T(i);
      }
      l1low = (p.det != 0.0) ? (-l0 * T(p.m1) + l1 * T(p.m0)) / T(p.det) : T(0);
      l1low = nan_min(l1low, T(0));
    }
    const T src0 = s[0];
    const T right = nan_max(s[ssize - 1], T(0));
    auto ext = [&](int e) -> T {
      if (e < shift) return nan_max(src0 + l1low * T(e - shift), T(0));
      if (e < shift + ssize) return s[e - shift];
      return right;
    };
    T part = T(-INFINITY);
    for (int e = tr; e < size_ext; e += kTeam) {
      const T v = ext(e);
      b2[e] = v;  // ext, for plocha
      part = nan_max(part, v);
    }
    maxch = team_max<T>(team, part);

    // ---- 2. Markov smoothing (log space, scale-invariant) --------------
    const T safe = maxch > T(0) ? maxch : T(1);
    for (int e = tr; e < size_ext; e += kTeam) b0[e] = b2[e] / safe;  // y
    const T y0 = ext(0) / safe, yx = ext(xmax) / safe;
    for (int m = 1 + tr; m <= marg; m += kTeam) {
      b0[-m] = y0;        // y[max(i-l+1, 0)]
      b0[xmax + m] = yx;  // y[min(i+l, xmax)]
    }
    if (tr == 0) b1[0] = T(0);
    team.sync();
    for (int i = tr; i < xmax; i += kTeam) {
      const T nip = b0[i], nim = b0[i + 1];
      // l = 1: the backward term's argument is the forward one negated
      // (the same sum, the numerator's exact negation), so one sqrt and
      // one division serve both
      const T s1 = nim + nip;
      const T q1 = (nim - nip) / ((s1 <= T(0)) ? T(1) : sqrt(s1));
      T sp = exp(q1), sm = exp(-q1);
      for (int l = 2; l <= p.aver_window; ++l) {
        const T a_f = b0[i + l];
        const T sf = a_f + nip;
        const T den_f = (sf <= T(0)) ? T(1) : sqrt(sf);
        sp = sp + exp((a_f - nip) / den_f);
        const T a_b = b0[i - l + 1];
        const T sb = a_b + nim;
        const T den_b = (sb <= T(0)) ? T(1) : sqrt(sb);
        sm = sm + exp((a_b - nim) / den_b);
      }
      b1[i + 1] = log(sp) - log(sm);  // logr
    }
  }
  // The bin-order sums, one owner each, the tile's owners in one warp:
  // thread 2j the cumsum of lane j's logr (logw, from 0), thread 2j + 1
  // the running sum of its ext (plocha at the end).
  __syncthreads();
  if (threadIdx.x < 2 * nl) {
    T* const a = frame(threadIdx.x >> 1, (threadIdx.x & 1) ? 2 : 1);
    T acc = T(0);
    for (int e = 0; e < size_ext; ++e) {
      acc = acc + a[e];
      a[e] = acc;
    }
  }
  __syncthreads();
  if (live) {
    T part = T(-INFINITY);
    for (int e = tr; e < size_ext; e += kTeam) part = nan_max(part, b1[e]);
    const T wmaxl = team_max<T>(team, part);  // b1[0] = 0 is in it
    plocha = b2[xmax];
    for (int e = tr; e < size_ext; e += kTeam) b1[e] = exp(b1[e] - wmaxl);  // w
  }
  __syncthreads();
  if (threadIdx.x < nl) {  // thread j: sumw of lane j
    const T* const w = frame(threadIdx.x, 1);
    T sumw = T(0);
    for (int e = 0; e < size_ext; ++e) sumw = sumw + w[e];
    frame(threadIdx.x, 2)[R - marg] = sumw;  // the lane's sc[0]
  }
  __syncthreads();
  if (!live) return;  // no block sync follows
  {
    const T sumw = sc[0];
    for (int e = tr; e < size_ext; e += kTeam) {
      b2[e] = fabs(b1[e] / sumw * plocha);  // sabs
      b0[e] = T(1);                         // the first Gold iterate
    }
    for (int m = 1 + tr; m <= marg; m += kTeam) {
      b0[-m] = T(0);
      b0[xmax + m] = T(0);
      b2[-m] = T(0);
      b2[xmax + m] = T(0);
    }
  }
  team.sync();

  // ---- 3. Gold deconvolution ---------------------------------------
  // chunk ch of C bins to thread ch % kTeam; bins past size_ext are dropped
  for (int e0 = tr * C; e0 < size_ext; e0 += kTeam * C) {
    T pv[C];
    tap_sums<C>(b2 - L, s_resp, p.lh_gold, e0, pv);
#pragma unroll
    for (int b = 0; b < C; ++b)
      if (e0 + b < size_ext) b1[e0 + b] = pv[b];  // pvec
  }
  team.sync();
  T* cur = b0;
  T* nxt = b2;
  T full = T(0);  // the sum of all bvec taps, in tap order
  for (int j = 0; j <= 2 * L; ++j) full = full + s_bvec[j];
  for (int it = 0; it < p.iters; ++it) {
    for (int e0 = tr * C; e0 < size_ext; e0 += kTeam * C) {
      T den[C];
      if (it == 0) {
        // x is 1 on the frame and 0 on its margins: den is the sum of the
        // taps that land on the frame, in tap order (a zero product adds
        // nothing, exactly), the full sum away from the edges
#pragma unroll
        for (int b = 0; b < C; ++b) {
          const int e = e0 + b;
          const int jlo = max(0, L - e), jhi = min(2 * L, xmax - e + L);
          T d = full;
          if (jlo > 0 || jhi < 2 * L) {
            d = T(0);
            for (int j = jlo; j <= jhi; ++j) d = d + s_bvec[j];
          }
          den[b] = d;
        }
      } else {
        tap_sums<C>(cur - L, s_bvec, 2 * L + 1, e0, den);
      }
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const int e = e0 + b;
        if (e >= size_ext) break;
        const T pv = b1[e], xv = cur[e];
        const bool cond = fabs(pv) > T(1e-5) && fabs(xv) > T(1e-5);
        const T factor = (den[b] != T(0) && pv != T(0)) ? pv / den[b] : T(0);
        // JAX keeps `prev` = the previous iterate (zeros before the first)
        nxt[e] = cond ? factor * xv : (it == 0 ? T(0) : xv);
      }
    }
    team.sync();
    T* const t = cur;
    cur = nxt;
    nxt = t;
  }
  // decon[e] = area * x[e - (posit - L)] (circular) on the range, zero off
  // it and in the rows -1 and size_ext; into b1 (pvec is spent)
  T* const decon = b1;
  {
    const T area = T(p.area);
    int off = (p.posit - L) % size_ext;
    if (off < 0) off += size_ext;
    const int hi = min(ssize + shift, size_ext - L);
    T part_d = T(-INFINITY), part_s = T(-INFINITY);
    for (int e = tr; e < size_ext; e += kTeam) {
      T d = T(0);
      if (e >= shift && e < hi) {
        int q = e - off;
        if (q < 0) q += size_ext;
        d = area * cur[q];
        part_s = nan_max(part_s, s[e - shift]);  // ext on the range
      }
      part_d = nan_max(part_d, d);
      decon[e] = d;
    }
    if (tr == 0) {
      decon[-1] = T(0);
      decon[size_ext] = T(0);
    }
    sc[1] = team_max<T>(team, part_d);  // every thread, the same value
    sc[2] = team_max<T>(team, part_s);
  }
  team.sync();
  const T max_decon = sc[1], maximum = sc[2];

  // ---- 4./5. accept, centroid, window selects, sort operands -------
  const T thr_decon = T(p.specthres) * max_decon;
  const T thr_src = T(p.specthres) * maximum;
  const int cmin = p.aux_offset - 1 < 0 ? p.aux_offset - 1 : 0;
  const int cmax = p.aux_offset + 1 > 0 ? p.aux_offset + 1 : 0;
  const int hi = min(ssize + shift, size_ext - L);
  // the source and aux spectra placed in the extended frame, zero outside
  auto pad_src = [&](int q) -> T {
    return (q >= shift && q < shift + ssize) ? s[q - shift] : T(0);
  };
  auto pad_aux = [&](int q) -> T {
    return (q >= shift && q < shift + ssize) ? ax[q - shift] : T(0);
  };
  struct Operands { T nk, a, py, ax; };
  auto operands = [&](int t) -> Operands {
    const int e = t + shift;
    const T d0 = decon[e - 1], d1 = decon[e], d2 = decon[e + 1];
    const bool is_lmax = e >= 1 && e <= xmax - 1 && d1 > d0 && d1 > d2;
    const bool accept = is_lmax && e < hi && d1 > thr_decon &&
                        s[t] > thr_src && maxch > T(0);
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
    const T key = (kk - e >= -1 && kk - e <= 1) ? pad_src(kk) : s[t];
    const int kr = k_round + shift;
    const T py = (kr - e >= -1 && kr - e <= 1) ? pad_src(kr) : s[t];
    const int tgt = min(max(k_round + p.aux_offset, 0), ssize - 1) + shift;
    const T av = (tgt - e >= cmin && tgt - e <= cmax) ? pad_aux(tgt) : ax[t];
    return {accept ? -key : T(INFINITY), a, py, av};
  };
  if (p.select_p == 0) {
    T* const out[4] = {negkey, cent, posy, auxsel};
    const size_t row = (size_t)lane * ssize;
    for (int t = tr; t < ssize; t += kTeam) {
      const Operands o = operands(t);
      out[0][row + t] = o.nk;
      out[1][row + t] = o.a;
      out[2][row + t] = o.py;
      out[3][row + t] = o.ax;
    }
    return;
  }

  // ---- 6. top-P selection (select mode) ----------------------------
  // P rounds of a stable ascending sort on negkey, one entry a round: the
  // smallest key, finite keys before +inf before NaN (as torch.sort orders
  // them), the smallest bin among equal keys; the bin taken is flagged.
  // A thread's scan keeps its first bin of a kind (strict <), then the
  // team reduces (kind, key, bin) as a tree, which is exact. The slot's
  // other operands are computed again at the bin taken, so every slot
  // equals the sort's, past the accepted ones too.
  T* const keys = nxt;   // the previous Gold iterate is spent
  T* const taken = cur;  // and so is the last, now in decon
  for (int t = tr; t < ssize; t += kTeam) {
    keys[t] = operands(t).nk;
    taken[t] = T(0);
  }
  team.sync();
  const size_t row = (size_t)lane * p.select_p;
  for (int q = 0; q < p.select_p; ++q) {
    int kind = 3, hit = -1;  // kind 0 finite, 1 +inf, 2 NaN, 3 none left
    T best = T(INFINITY);
    for (int t = tr; t < ssize; t += kTeam) {
      if (taken[t] != T(0)) continue;
      const T v = keys[t];
      const int c = v != v ? 2 : (v == T(INFINITY) ? 1 : 0);
      if (c < kind || (c == 0 && kind == 0 && v < best)) {
        kind = c;
        best = v;
        hit = t;
      }
    }
#pragma unroll
    for (int o = kTeam / 2; o > 0; o >>= 1) {
      const int oc = team.shfl_xor(kind, o);
      const T ob = team.shfl_xor(best, o);
      const int oh = team.shfl_xor(hit, o);
      bool take;
      if (oc != kind) take = oc < kind;
      else if (kind == 3) take = false;
      else if (kind == 0 && ob != best) take = ob < best;
      else take = oh < hit;
      if (take) {
        kind = oc;
        best = ob;
        hit = oh;
      }
    }
    if (tr == 0) {
      negkey[row + q] = best;
      const Operands o = hit < 0 ? Operands{best, T(0), T(0), T(0)} : operands(hit);
      cent[row + q] = o.a;
      posy[row + q] = o.py;
      auxsel[row + q] = o.ax;
    }
    if (hit >= 0 && hit % kTeam == tr) taken[hit] = T(1);
    team.sync();
  }
}

template <typename T>
static cudaError_t launch(const void* src, const void* aux, const void* taps,
                          void* const* out, SearchParams p, int n,
                          cudaStream_t st) {
  size_t smem = 0;
  p.lanes = plan_search(sizeof(T), p.ssize, p.size_ext, p.marg, p.lh_gold, smem);
  if (p.lanes == 0) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(search_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  search_kernel<T><<<(n + p.lanes - 1) / p.lanes, p.lanes * kTeam, smem, st>>>(
      (const T*)src, (const T*)aux, (const T*)taps, (T*)out[0], (T*)out[1],
      (T*)out[2], (T*)out[3], p, n);
  return cudaGetLastError();
}

}  // namespace npswf

// The layout of a search at ssize bins, this shift, Gold reach lh_gold - 1
// and Markov window: the lanes a block (8 at every default setting, fewer
// as the frames grow), 0 where not even one lane's frames fit a block's
// shared memory (refused).
extern "C" int npswf_search_layout(int dtype, int ssize, int shift,
                                   int lh_gold, int aver_window) {
  const size_t tsize = dtype == npswf::kFloat32 ? sizeof(float) : sizeof(double);
  const int size_ext = ssize + 2 * shift;
  const int marg = npswf::search_margin(lh_gold - 1, aver_window);
  size_t smem = 0;
  return npswf::plan_search(tsize, ssize, size_ext, marg, lh_gold, smem);
}

// select_p = 0: the four operands, each [N, T]; select_p = P > 0: the
// first P slots of their stable sort on negkey, each [N, P]. taps: resp
// (lh_gold values) then bvec (2*lh_gold - 1), on the card in the working
// type.
extern "C" int npswf_search(
    int dtype, const void* src, const void* aux, const void* taps,
    void* negkey, void* cent, void* posy, void* auxsel, int n,
    int ssize, int shift, int kfit, int lh_gold, int posit, int aver_window,
    int iters, int aux_offset, int select_p, double m0, double m1, double det,
    double area, double specthres, void* stream) {
  if (lh_gold < 1 || aver_window < 1 || ssize < 1 || shift < 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  npswf::SearchParams p;
  p.ssize = ssize;
  p.shift = shift;
  p.size_ext = ssize + 2 * shift;
  p.marg = npswf::search_margin(lh_gold - 1, aver_window);
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
  void* out[4] = {negkey, cent, posy, auxsel};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == npswf::kFloat32
                   ? npswf::launch<float>(src, aux, taps, out, p, n, st)
                   : npswf::launch<double>(src, aux, taps, out, p, n, st));
}

// K5, K6 and K7: the system evaluations of the generic LM loop.
//
// K5 fused_eval replaces npswf_tpu/fit/pallas_eval.py::_kernel (wrapper
// fused_eval): the spline model f [N, K] and the per-pulse Jacobian windows
// Jt = -A * s'(x - t) and Ja = s(x - t), each [N, P, K], over the fit bins.
// One thread per (lane, fit bin), looping over the P pulses in order: u =
// ceil(t + x0) - (t + x0), the four coefficients at segment slot
// (fit_lo + PAD + k - ceil(t + x0)) mod SEG (the TPU kernel's barrel shift
// as a direct load, wrapping for t + x0 > fit_lo + PAD - 1), Horner for the
// value and the derivative, the support gate 1 < x - t < ntime - 1 and the
// pulse mask; f accumulates from the pedestal in pulse order.
// What bounds it on the card: device memory. At P = 2 and N = 69,120 it
// reads the [N, 4, 128] planes (141.6 MB in fp32) and writes f, Jt and Ja
// (124.4 MB); the arithmetic is ~20 flops an output. What the design does
// about it: consecutive threads take consecutive fit bins of one lane, so
// the output rows are written coalesced and each lane's coefficient window
// is read as contiguous runs; nothing is staged.
//
// K6 fused_system replaces npswf_tpu/fit/pallas_eval.py::_system_kernel
// (wrapper fused_system): the sin bound transform, the spline model, the M
// weighted Jacobian columns over the K fit bins and the normal equations
// A = Ju^T Ju, g = Ju^T r and chi2 = r^T r in one call, for a pulse count P
// given at run time. K7 fused_neq replaces _neq_kernel (wrapper fused_neq):
// the same sums from K5's outputs f, Jt, Ja and dp/du, P <= NARROW_P.
// What bounds them on the card: device memory. At P = 2, fp32 and N =
// 69,120, K6 reads the planes, y, w and the [N, M] parameter rows and writes
// A, g and chi2 (~203 MB); K7 reads y, w, f, Jt, Ja and dp/du (~181 MB). The
// MT + M + 1 sums (MT = M(M+1)/2) of K products a lane are ~3 flops a byte.
// What the design does about it:
//   - a block takes a tile of L lanes (by P and dtype, so that a tile needs
//     at most kTileBudget of shared memory) and stages what the tile reads,
//     each a contiguous span of the caller's tensors, with asynchronous
//     16-byte copies (copy_span_async, cp.async: every thread issues all
//     its copies before it waits, so a tile's loads are in flight at once):
//     K6 the coefficient planes and the y and w rows, K7 the y, w, f, Jt and
//     Ja rows and dp/du. Rows of a tensor with a longer row stride (y is a
//     window of the signal) are copied value by value, coalesced;
//   - K6 runs the transform once a component (M sin/cos a lane), and the
//     spline fraction and slot once a pulse, into shared memory;
//   - phase (a): one thread a (lane, bin) writes the bin's M weighted
//     columns and the weighted residual to shared memory (K6 through
//     bin_columns, the function K3 calls, so the two round alike);
//   - phase (b), gram_reduce: A, g and chi2 are the upper triangle of the
//     C x C Gram matrix of the bin rows [cols | r], C = M + 1. Each of its
//     sums has one owner thread, which adds it over the bins in order from
//     zero, the plain version's order (no shuffle tree, no split partial
//     sums). A thread owns an R x R block of entries (R = 2, or 4 above
//     C = 12), so it reads 2R values a bin for R^2 sums. The owners of one
//     block are consecutive lanes, whose rows lie an odd number of values
//     apart, so a warp's reads fall in distinct banks;
//   - the bins go in chunks of at most 32, so the columns of a chunk take
//     a third of the shared memory of a whole row at K = 90, and the owners'
//     sums stay in registers from chunk to chunk;
//   - A (both triangles from the one sum), g and chi2 go out in the caller's
//     layout ([N, M, M], [N, M], [N]) through shared memory, as contiguous
//     spans: a call is one launch, with no transpose and no unpack.
// Past what a tile of one lane holds (one owner block a thread in
// kTileThreads, or the card's shared memory for the staged outputs; at K =
// 90 above P = 61), the plan takes the wide layout: one lane a block of
// kTileThreads, each thread taking its owner blocks in turn (u = tid, tid +
// kTileThreads, ...). An owner's sums go straight to A, g and chi2 in the
// caller's layout after each chunk and come back from there at the next, so
// each sum still adds the bins in order from zero; nothing is staged for
// the outputs, and chunks shrink (down to one bin) until the lane's staged
// arrays fit. Only where not even that fits (at K = 90 on a card with 227
// KB a block, from 3,337 pulses in fp64 and 6,380 in fp32) is the width
// refused (npswf_system_layout).
//
// Compiled with -fmad=false: each product and sum rounds as in the plain
// PyTorch versions (fit/eval_kernel.py), which sum over the bins in order.
#include "spline_system.cuh"

namespace npswf {

struct SysParams {
  double gate_lo, gate_hi;
  int fit_lo, nk, n, p;
  long long ld[3];  // row strides, in values, of y, w and f (K6, K7)
};

// shared memory of a K6/K7 tile: 8 lanes at P = 2 in fp32, 4 at P = 12, so
// that several tiles share an SM and overlap their copies with the others'
// sums (budgets of 16, 24, 64 and 112 KB timed slower, 48 KB the same)
constexpr size_t kTileBudget = 32 * 1024;
constexpr int kTileThreads = 512;          // most threads of a K6/K7 block

// ---- K5 -------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kBlock)
eval_kernel(const T* __restrict__ coeffs, const T* __restrict__ x0,
            const T* __restrict__ tpar, const T* __restrict__ apar,
            const T* __restrict__ ped, const uint8_t* __restrict__ mask,
            T* __restrict__ f, T* __restrict__ jt, T* __restrict__ ja,
            SysParams prm, int p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)prm.n * prm.nk) return;
  const int lane = (int)(idx / prm.nk);
  const int k = (int)(idx % prm.nk);
  const T* coef = coeffs + (size_t)lane * 4 * kSeg;
  const T xk = T(k) + T(prm.fit_lo);
  const T x0l = x0[lane];
  const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
  T acc = ped[lane];
  for (int q = 0; q < p; ++q) {
    const size_t pq = (size_t)lane * p + q;
    const T tp = tpar[pq], amp = apar[pq];
    const T act = mask[pq] ? T(1) : T(0);
    const T tau = tp + x0l;
    const T ceil_t = ceil(tau);
    const T uu = ceil_t - tau;
    const long long b = (long long)prm.fit_lo + kPad - (long long)ceil_t + k;
    const int s = (int)(((b % kSeg) + kSeg) % kSeg);
    const T ca = coef[s], cb = coef[kSeg + s], cc = coef[2 * kSeg + s],
            cd = coef[3 * kSeg + s];
    const T sval = ((cd * uu + cc) * uu + cb) * uu + ca;
    const T sder = (T(3) * cd * uu + T(2) * cc) * uu + cb;
    const T rel = xk - tp;
    const bool gate = rel > gate_lo && rel < gate_hi;
    const T val = (gate ? sval : T(0)) * act;
    const T der = (gate ? sder : T(0)) * act;
    acc = acc + amp * val;
    jt[pq * prm.nk + k] = -amp * der;
    ja[pq * prm.nk + k] = val;
  }
  f[(size_t)lane * prm.nk + k] = acc;
}


// ---- K6 and K7: a tile of lanes a block ------------------------------

// A tile's geometry, computed on the host: L lanes a block; the Gram matrix
// of C = M + 1 columns cut into nb x nb blocks of R x R entries, U =
// nb(nb + 1)/2 owner blocks a lane; kc bins a chunk, a lane's chunk of
// columns LS (odd) values long. off: the staged arrays, in values of T from
// the start of shared memory; o_cs the chunk's columns; o_int, in bytes, the
// int arrays.
// wide: 0 the tile layout, 1 one lane a block with the sums through the
// outputs.
struct Tile {
  int L, R, C, nb, U, kc, LS, threads, wide;
  int off[7];
  int o_cs;
  size_t o_int, smem;
};

// Offsets of L lanes' staged arrays (per_lane values a lane each, then
// the chunk's columns) and, past them, ints ints a lane: the bytes.
static size_t place(Tile& t, int L, const int* per_lane, int narr, int ints,
                    size_t tsz) {
  size_t o = 0;
  for (int a = 0; a < narr; ++a) {
    t.off[a] = (int)o;
    o += (size_t)L * per_lane[a];
  }
  t.o_cs = (int)o;
  o += (size_t)L * t.LS;
  t.o_int = (o * tsz + 15) / 16 * 16;
  return t.o_int + (size_t)L * ints * sizeof(int);
}

// The largest power of two L <= 64 whose tile needs at most kTileBudget of
// shared memory (L = 1 up to the card's opt-in limit), with one owner block
// a thread in at most kTileThreads threads. per_lane: the staged arrays'
// values a lane; ints: int values a lane. The outputs' staging aliases them.
// Past that, the wide layout (above).
static bool plan_tile(size_t tsz, int p, int nk, const int* per_lane, int narr,
                      int ints, size_t optin, Tile& t) {
  const int M = 1 + 2 * p;
  t.C = M + 1;
  t.R = t.C <= 12 ? 2 : 4;
  t.nb = (t.C + t.R - 1) / t.R;
  t.U = t.nb * (t.nb + 1) / 2;
  const int nch = nk > 0 ? (nk + 31) / 32 : 1;
  t.kc = nk > 0 ? (nk + nch - 1) / nch : 1;
  t.LS = (t.kc * t.C) | 1;
  t.wide = 0;
  const size_t out_vals = (size_t)M * M + M + 1;
  for (int L = 64; L >= 1; L /= 2) {
    size_t vals = 0;
    for (int a = 0; a < narr; ++a) vals += (size_t)L * per_lane[a];
    vals += (size_t)L * t.LS;
    const size_t o_int = (vals * tsz + 15) / 16 * 16;
    size_t bytes = o_int + (size_t)L * ints * sizeof(int);
    if (bytes < (size_t)L * out_vals * tsz) bytes = (size_t)L * out_vals * tsz;
    const int owners = (L * t.U + 31) / 32 * 32;
    const int threads = owners < 128 ? 128 : owners;
    if ((bytes <= kTileBudget && threads <= kTileThreads) || L == 1) {
      if (bytes > optin || threads > kTileThreads) break;
      t.L = L;
      t.threads = threads;
      t.smem = bytes;
      place(t, L, per_lane, narr, ints, tsz);
      return true;
    }
  }
  // the wide layout: one lane, chunks down to one bin within the card's
  // shared memory
  t.L = 1;
  const int owners = (t.U + 31) / 32 * 32;
  t.threads = owners < 128 ? 128 : owners > kTileThreads ? kTileThreads : owners;
  t.wide = 1;
  for (int kc = t.kc; kc >= 1; --kc) {
    t.LS = (kc * t.C) | 1;
    const size_t bytes = place(t, 1, per_lane, narr, ints, tsz);
    if (bytes <= optin) {
      t.kc = kc;
      t.smem = bytes;
      return true;
    }
  }
  return false;
}

// K6 stages a lane's planes [4, SEG], y [K], w [K], the physical parameters
// and dp/du [M], the spline fractions and pulse masks [P]; ints: the slots [P].
static bool plan_system(size_t tsz, int p, int nk, size_t optin, Tile& t) {
  const int M = 1 + 2 * p;
  const int sizes[7] = {4 * kSeg, nk, nk, M, M, p, p};
  return p >= 1 && nk >= 0 && plan_tile(tsz, p, nk, sizes, 7, p, optin, t);
}

// K7 stages a lane's y, w, f [K], Jt, Ja [P, K] and dp/du [M]; at its P <=
// NARROW_P a tile of lanes always fits, so it takes no wide layout.
static bool plan_neq(size_t tsz, int p, int nk, size_t optin, Tile& t) {
  const int M = 1 + 2 * p;
  const int sizes[6] = {nk, nk, nk, p * nk, p * nk, M};
  return p >= 1 && nk >= 0 && plan_tile(tsz, p, nk, sizes, 6, 0, optin, t) &&
         t.wide == 0;
}

template <typename T>
__device__ __forceinline__ void store_span(T* __restrict__ g, const T* s,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) g[i] = s[i];
}

// The sums one thread owns: entries (i0 + a, j0 + b), a, b < R, of the
// upper triangle of the Gram matrix of tile lane ``lane``'s bin rows.
// Owner block u of a lane goes to thread lane + u L (the wide layout: u
// given). Columns past C - 1 read column C - 1 and are not stored.
template <typename T, int R>
struct Owner {
  T acc[R][R];
  int lane, i0, j0;
  bool on;

  __device__ Owner(const Tile& t, int lanes) {
    lane = threadIdx.x % t.L;
    int u = threadIdx.x / t.L;
    on = u < t.U && lane < lanes;
    place(t, u);
  }

  __device__ Owner(const Tile& t, int lane_, int u) : lane(lane_), on(true) {
    place(t, u);
  }

  __device__ __forceinline__ void place(const Tile& t, int u) {
    int bi = 0;
    if (on)
      while (u >= t.nb - bi) {
        u -= t.nb - bi;
        ++bi;
      }
    i0 = bi * R;
    j0 = (bi + u) * R;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = T(0);
  }

  // Bins 0..kc-1 of a chunk, in order; bin kk's row is at cs + lane LS + kk C.
  __device__ __forceinline__ void add(const T* cs, const Tile& t, int kc) {
    if (!on) return;
    int ci[R], cj[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      ci[a] = min(i0 + a, t.C - 1);
      cj[a] = min(j0 + a, t.C - 1);
    }
    const T* row = cs + (size_t)lane * t.LS;
#pragma unroll 2
    for (int kk = 0; kk < kc; ++kk, row += t.C) {
      T x[R], y[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        x[a] = row[ci[a]];
        y[a] = row[cj[a]];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = acc[a][b] + x[a] * y[b];
    }
  }

  // Entry (i, j), i <= j <= M: A(i, j) and A(j, i) for j < M, g(i) for
  // j = M, chi2 for i = j = M, into As [L, M, M], gs [L, M], c2 [L] (the
  // staging, or the outputs themselves).
  __device__ __forceinline__ void put(T* As, T* gs, T* c2, int M) const {
    if (!on) return;
    T* Al = As + (size_t)lane * M * M;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i > j || j > M) continue;
        if (j < M) {
          Al[i * M + j] = acc[a][b];
          Al[j * M + i] = acc[a][b];
        } else if (i < M) {
          gs[lane * M + i] = acc[a][b];
        } else {
          c2[lane] = acc[a][b];
        }
      }
  }

  // The sums put() stored, back into acc (the wide layout's next chunk).
  __device__ __forceinline__ void get(const T* As, const T* gs, const T* c2,
                                      int M) {
    const T* Al = As + (size_t)lane * M * M;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i > j || j > M) continue;
        acc[a][b] = j < M ? Al[i * M + j] : i < M ? gs[lane * M + i] : c2[lane];
      }
  }
};

// Phases (a) and (b) of K6 and K7, and their outputs. build(lane, k, row)
// writes bin k's M weighted columns and weighted residual of tile lane
// ``lane`` to row[0..M]. Each owner adds its sums over the bins in order
// from zero, chunk after chunk. Then the sums go through shared memory
// (the staged arrays are dead by then) to A [N, M, M], g [N, M] and
// chi2 [N] as contiguous spans. The wide layout (one lane) has each thread
// take its owner blocks in turn, their sums through A, g and chi2 between
// chunks.
template <typename T, int R, bool Wide, typename Build>
__device__ __forceinline__ void gram_reduce(const Tile& t, T* s, int lanes,
                                            int M, int nk, long long lane0,
                                            Build build, T* A, T* g, T* chi2) {
  T* cs = s + t.o_cs;
  if constexpr (Wide) {
    T* Al = A + lane0 * M * M;
    T* gl = g + lane0 * M;
    T* cl = chi2 + lane0;
    // one pass at least: with no bins the owners store zero sums, as the
    // tile's do
    for (int k0 = 0; k0 < max(nk, 1); k0 += t.kc) {
      const int kc = min(t.kc, nk - k0);
      for (int kk = threadIdx.x; kk < kc; kk += blockDim.x)
        build(0, k0 + kk, cs + kk * t.C);
      __syncthreads();
      for (int u = threadIdx.x; u < t.U; u += blockDim.x) {
        Owner<T, R> own(t, 0, u);
        if (k0 > 0) own.get(Al, gl, cl, M);
        own.add(cs, t, kc);
        own.put(Al, gl, cl, M);
      }
      __syncthreads();
    }
    return;
  }
  Owner<T, R> own(t, lanes);
  for (int k0 = 0; k0 < nk; k0 += t.kc) {
    const int kc = min(t.kc, nk - k0);
    for (int i = threadIdx.x; i < lanes * kc; i += blockDim.x) {
      const int lane = i / kc, kk = i - lane * kc;
      build(lane, k0 + kk, cs + (size_t)lane * t.LS + kk * t.C);
    }
    __syncthreads();
    own.add(cs, t, kc);
    __syncthreads();
  }
  T* As = s;
  T* gs = As + (size_t)t.L * M * M;
  T* c2 = gs + (size_t)t.L * M;
  own.put(As, gs, c2, M);
  __syncthreads();
  store_span(A + lane0 * M * M, As, lanes * M * M);
  store_span(g + lane0 * M, gs, lanes * M);
  store_span(chi2 + lane0, c2, lanes);
}

// ---- K6 -------------------------------------------------------------
template <typename T, int R, bool Wide>
__global__ void __launch_bounds__(kTileThreads)
system_kernel(const T* __restrict__ coeffs, const T* __restrict__ x0,
              const T* __restrict__ y, const T* __restrict__ w,
              const T* __restrict__ u, const T* __restrict__ lo,
              const T* __restrict__ hi, const T* __restrict__ pseed,
              const uint8_t* __restrict__ pmask, T* __restrict__ A,
              T* __restrict__ g, T* __restrict__ chi2, SysParams prm, Tile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int P = prm.p, M = 1 + 2 * P, K = prm.nk;
  const long long lane0 = (long long)blockIdx.x * t.L;
  const int lanes = (int)min((long long)t.L, (long long)prm.n - lane0);
  T* planes = s + t.off[0];  // [L, 4, SEG]
  T* ys = s + t.off[1];      // [L, K]
  T* ws = s + t.off[2];      // [L, K]
  T* pp = s + t.off[3];      // [L, M] physical parameters
  T* dp = s + t.off[4];      // [L, M] dp/du
  T* uu = s + t.off[5];      // [L, P] spline fractions
  T* actp = s + t.off[6];    // [L, P] pulse masks
  int* base = reinterpret_cast<int*>(smem + t.o_int);  // [L, P] slots of bin 0
  copy_span_async(planes, coeffs + lane0 * 4 * kSeg, lanes * 4 * kSeg);
  copy_rows_async(ys, y + lane0 * prm.ld[0], prm.ld[0], lanes, K);
  copy_rows_async(ws, w + lane0 * prm.ld[1], prm.ld[1], lanes, K);
  // while the copies fly: the transform, component i of the tile's rows
  // [lanes, M]; a time component also gives its pulse's fraction, slot and
  // mask
  for (int i = threadIdx.x; i < lanes * M; i += blockDim.x) {
    const int lane = i / M, c = i - lane * M;
    const size_t row = (size_t)lane0 * M + i;
    const T l = lo[row], h = hi[row];
    const T half = T(0.5) * (h - l), mid = T(0.5) * (h + l);
    const bool ok = pmask[row] != 0 && half > T(0);
    transform_one(sin(u[row]), cos(u[row]), mid, half, pseed[row], ok, pp[i],
                  dp[i]);
    if (c & 1) {
      const int q = lane * P + c / 2;
      pulse_slot(pp[i], x0[lane0 + lane], prm.fit_lo, uu[q], base[q]);
      actp[q] = pmask[row + 1] ? T(1) : T(0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const T gate_lo = T(prm.gate_lo), gate_hi = T(prm.gate_hi);
  gram_reduce<T, R, Wide>(t, s, lanes, M, K, lane0,
                          [&](int lane, int k, T* row) {
                            const int b = lane * P;
                            bin_columns<T, 0>(k, prm.fit_lo, gate_lo, gate_hi,
                                              ws[lane * K + k], ys[lane * K + k],
                                              planes + lane * 4 * kSeg,
                                              pp + lane * M, dp + lane * M,
                                              uu + b, base + b, actp + b, row,
                                              row[M], P);
                          },
                          A, g, chi2);
}

// ---- K7 -------------------------------------------------------------
template <typename T, int R>
__global__ void __launch_bounds__(kTileThreads)
neq_kernel(const T* __restrict__ y, const T* __restrict__ w,
           const T* __restrict__ f, const T* __restrict__ jt,
           const T* __restrict__ ja, const T* __restrict__ dpdu,
           T* __restrict__ A, T* __restrict__ g, T* __restrict__ chi2,
           SysParams prm, Tile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int P = prm.p, M = 1 + 2 * P, K = prm.nk;
  const long long lane0 = (long long)blockIdx.x * t.L;
  const int lanes = (int)min((long long)t.L, (long long)prm.n - lane0);
  T* ys = s + t.off[0];   // [L, K]
  T* ws = s + t.off[1];   // [L, K]
  T* fs = s + t.off[2];   // [L, K]
  T* jts = s + t.off[3];  // [L, P, K]
  T* jas = s + t.off[4];  // [L, P, K]
  T* dps = s + t.off[5];  // [L, M]
  copy_rows_async(ys, y + lane0 * prm.ld[0], prm.ld[0], lanes, K);
  copy_rows_async(ws, w + lane0 * prm.ld[1], prm.ld[1], lanes, K);
  copy_rows_async(fs, f + lane0 * prm.ld[2], prm.ld[2], lanes, K);
  copy_span_async(jts, jt + lane0 * P * K, lanes * P * K);
  copy_span_async(jas, ja + lane0 * P * K, lanes * P * K);
  copy_span_async(dps, dpdu + lane0 * M, lanes * M);
  cp_async_wait_all();
  __syncthreads();
  // the plain version's columns: dp_0 w, (jt_q dp) w, (ja_q dp) w; r = (y - f) w
  gram_reduce<T, R, false>(t, s, lanes, M, K, lane0,
                           [&](int lane, int k, T* row) {
                             const T* d = dps + lane * M;
                             const T* jl = jts + (size_t)lane * P * K + k;
                             const T* al = jas + (size_t)lane * P * K + k;
                             const T wk = ws[lane * K + k];
                             row[0] = d[0] * wk;
                             for (int q = 0; q < P; ++q) {
                               row[1 + 2 * q] = jl[q * K] * d[1 + 2 * q] * wk;
                               row[2 + 2 * q] = al[q * K] * d[2 + 2 * q] * wk;
                             }
                             row[M] = (ys[lane * K + k] - fs[lane * K + k]) * wk;
                           },
                           A, g, chi2);
}

// One launch of a tile kernel: a block a tile, its shared memory allowed
// above 48 KB (allow_smem).
template <typename Kernel, typename... Args>
static cudaError_t launch_tile(Kernel kernel, const Tile& t, int n,
                               cudaStream_t st, Args... args) {
  const cudaError_t e = allow_smem(kernel, t.smem);
  if (e != cudaSuccess) return e;
  kernel<<<(n + t.L - 1) / t.L, t.threads, t.smem, st>>>(args..., t);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_system(const void* const* in, void* const* out,
                                 const SysParams& prm, cudaStream_t st) {
  Tile t;
  if (!plan_system(sizeof(T), prm.p, prm.nk, smem_optin(), t))
    return cudaErrorInvalidValue;
  auto kernel = t.wide ? (t.R == 2 ? system_kernel<T, 2, true> : system_kernel<T, 4, true>)
                       : (t.R == 2 ? system_kernel<T, 2, false> : system_kernel<T, 4, false>);
  return launch_tile(kernel, t, prm.n, st, (const T*)in[0], (const T*)in[1],
                     (const T*)in[2], (const T*)in[3], (const T*)in[4],
                     (const T*)in[5], (const T*)in[6], (const T*)in[7],
                     (const uint8_t*)in[8], (T*)out[0], (T*)out[1], (T*)out[2],
                     prm);
}

template <typename T>
static cudaError_t launch_neq(const void* const* in, void* const* out,
                              const SysParams& prm, cudaStream_t st) {
  Tile t;
  if (!plan_neq(sizeof(T), prm.p, prm.nk, smem_optin(), t))
    return cudaErrorInvalidValue;
  auto kernel = t.R == 2 ? neq_kernel<T, 2> : neq_kernel<T, 4>;
  return launch_tile(kernel, t, prm.n, st, (const T*)in[0], (const T*)in[1],
                     (const T*)in[2], (const T*)in[3], (const T*)in[4],
                     (const T*)in[5], (T*)out[0], (T*)out[1], (T*)out[2], prm);
}

}  // namespace npswf

// The layout of K6 at P pulses over nk fit bins: 0 the tile, 1 one lane a
// block with its sums through the outputs, -1 a width not even one lane of
// which fits a block's shared memory (refused).
extern "C" int npswf_system_layout(int dtype, int p, int nk) {
  const size_t tsz = dtype == npswf::kFloat32 ? sizeof(float) : sizeof(double);
  npswf::Tile t;
  return npswf::plan_system(tsz, p, nk, npswf::smem_optin(), t) ? t.wide : -1;
}

extern "C" int npswf_fused_eval(int dtype, const void* coeffs, const void* x0,
                                const void* tpar, const void* apar,
                                const void* ped, const void* mask, void* f,
                                void* jt, void* ja, int n, int p, int nk,
                                int fit_lo, double gate_lo, double gate_hi,
                                void* stream) {
  npswf::SysParams prm;
  prm.gate_lo = gate_lo;
  prm.gate_hi = gate_hi;
  prm.fit_lo = fit_lo;
  prm.nk = nk;
  prm.n = n;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)n * nk;
  const int grid = (int)((total + npswf::kBlock - 1) / npswf::kBlock);
  if (dtype == npswf::kFloat32)
    npswf::eval_kernel<float><<<grid, npswf::kBlock, 0, st>>>(
        (const float*)coeffs, (const float*)x0, (const float*)tpar,
        (const float*)apar, (const float*)ped, (const uint8_t*)mask, (float*)f,
        (float*)jt, (float*)ja, prm, p);
  else
    npswf::eval_kernel<double><<<grid, npswf::kBlock, 0, st>>>(
        (const double*)coeffs, (const double*)x0, (const double*)tpar,
        (const double*)apar, (const double*)ped, (const uint8_t*)mask,
        (double*)f, (double*)jt, (double*)ja, prm, p);
  return (int)cudaGetLastError();
}


// in: y, w, f, jt, ja, dpdu; out: A [N, M, M], g [N, M], chi2 [N];
// ldy, ldw, ldf: the row strides of y, w and f
extern "C" int npswf_fused_neq(int dtype, int p, const void* const* in,
                               void* const* out, int n, int nk, long long ldy,
                               long long ldw, long long ldf, void* stream) {
  npswf::SysParams prm{};
  prm.nk = nk;
  prm.n = n;
  prm.p = p;
  prm.ld[0] = ldy;
  prm.ld[1] = ldw;
  prm.ld[2] = ldf;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == npswf::kFloat32
                   ? npswf::launch_neq<float>(in, out, prm, st)
                   : npswf::launch_neq<double>(in, out, prm, st));
}

// in: coeffs, x0, y, w, u, lo, hi, pseed, pmask; out: A [N, M, M], g [N, M],
// chi2 [N]; ldy, ldw: the row strides of y and w
extern "C" int npswf_fused_system(int dtype, int p, const void* const* in,
                                  void* const* out, int n, int nk,
                                  long long ldy, long long ldw, int fit_lo,
                                  double gate_lo, double gate_hi, void* stream) {
  npswf::SysParams prm{};
  prm.gate_lo = gate_lo;
  prm.gate_hi = gate_hi;
  prm.fit_lo = fit_lo;
  prm.nk = nk;
  prm.n = n;
  prm.p = p;
  prm.ld[0] = ldy;
  prm.ld[1] = ldw;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == npswf::kFloat32
                   ? npswf::launch_system<float>(in, out, prm, st)
                   : npswf::launch_system<double>(in, out, prm, st));
}

// Copied from npswf_tpu/io/native/decode.cpp; tests/test_torch_host.py pins it there.
// Native host-side raw-stream decoder for the npswf_tpu framework.
//
// TPU-native counterpart of the per-event unpack loop in the reference's
// `analyze` lambda (ref TEST_2.C:854-889): parse the variable-length
// [slot, nsamp, s0..s(nsamp-1)]* stream of every event in a batch into dense
// [E, B, T] waveform tensors plus presence masks and per-block minima,
// remapping scintillator slots 2000/2001 -> 1080/1081 and aborting an
// event's decode on an out-of-range slot. This is the host-side hot loop
// that feeds the TPU; it is parallelized over events with std::thread.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libnpswf_host.so decode.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Decode a batch of events.
//   stream:         concatenated f64 raw streams
//   offsets:        [n_events+1] event boundaries in `stream`
//   n_events:       number of events
//   nblocks/ntime/nslots: geometry (1080 / 110 / 1104)
//   scint_a/scint_b: raw scintillator slot ids (2000 / 2001)
//   ndata_max:      Ndata guard — an event whose stream exceeds this is
//                   skipped entirely (ref TEST_2.C:830-836); <= 0 disables
//   signal_out:     [n_events * nblocks * ntime] f32, zero-filled by callee
//   pres_out:       [n_events * nslots] u8
//   minsig_out:     [n_events * nblocks] f32 (1e6 where block absent)
//   bad_slot_out:   [n_events] i32 — slot id that aborted the decode;
//                   -1 = clean, -2 = truncated stream (an nsamp ran past the
//                   event boundary), -3 = oversize (Ndata guard)
// Returns the number of events with decode problems.
int decode_batch(const double* stream, const int64_t* offsets, int64_t n_events,
                 int nblocks, int ntime, int nslots, int scint_a, int scint_b,
                 int64_t ndata_max, float* signal_out, uint8_t* pres_out,
                 float* minsig_out, int32_t* bad_slot_out, int n_threads) {
  std::atomic<int> n_bad{0};

  auto worker = [&](int64_t e0, int64_t e1) {
    for (int64_t e = e0; e < e1; ++e) {
      const double* s = stream + offsets[e];
      const int64_t n = offsets[e + 1] - offsets[e];
      float* sig = signal_out + e * (int64_t)nblocks * ntime;
      uint8_t* pres = pres_out + e * (int64_t)nslots;
      float* msig = minsig_out + e * (int64_t)nblocks;
      std::memset(sig, 0, sizeof(float) * (size_t)nblocks * ntime);
      std::memset(pres, 0, (size_t)nslots);
      for (int b = 0; b < nblocks; ++b) msig[b] = 1e6f;
      bad_slot_out[e] = -1;
      if (ndata_max > 0 && n > ndata_max) {           // ref :830-836
        bad_slot_out[e] = -3;
        n_bad.fetch_add(1, std::memory_order_relaxed);
        continue;                                     // event skipped entirely
      }

      int64_t ns = 0;
      while (ns + 2 <= n) {
        long bloc = (long)s[ns]; ns++;
        long nsamp = (long)s[ns]; ns++;
        if (bloc == scint_a) bloc = nblocks;          // 2000 -> 1080
        if (bloc == scint_b) bloc = nblocks + 1;      // 2001 -> 1081
        if (bloc < 0 || bloc > nslots - 1) {          // ref :867-872
          bad_slot_out[e] = (int32_t)bloc;
          n_bad.fetch_add(1, std::memory_order_relaxed);
          break;
        }
        pres[bloc] = 1;
        if (ns + nsamp > n) {                         // truncated/corrupt event:
          bad_slot_out[e] = -2;                       // never read past the
          n_bad.fetch_add(1, std::memory_order_relaxed);  // event's stream
        }
        if (bloc < nblocks) {
          float* row = sig + (int64_t)bloc * ntime;
          float mn = msig[bloc];
          const long lim = std::min<long>(
              std::min<long>(nsamp, (long)ntime), (long)(n - ns));
          for (long it = 0; it < lim; ++it) {
            const float v = (float)s[ns + it];
            row[it] = v;
            mn = std::min(mn, v);
          }
          msig[bloc] = mn;
        }
        ns += nsamp;
      }
    }
  };

  if (n_threads <= 1 || n_events < 4) {
    worker(0, n_events);
  } else {
    const int nt = std::min<int64_t>(n_threads, n_events);
    std::vector<std::thread> pool;
    const int64_t chunk = (n_events + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      const int64_t e0 = t * chunk;
      const int64_t e1 = std::min<int64_t>(e0 + chunk, n_events);
      if (e0 < e1) pool.emplace_back(worker, e0, e1);
    }
    for (auto& th : pool) th.join();
  }
  return n_bad.load();
}

// Flatten fixed-shape per-pulse arrays into the reference's ragged layout
// (ref TEST_2.C:585-587, 958-961, 1022, 1289-1296): for each event,
// concatenate each block's first npulse[b] slots in block order.
//   npulse:   [E * B] i32
//   times/amps: [E * B * P] f64
//   out_times/out_amps: caller-sized flat buffers
//   out_offsets: [E+1] event boundaries in the flat buffers
void flatten_pulses(const int32_t* npulse, const double* times,
                    const double* amps, int64_t n_events, int nblocks,
                    int maxp, double* out_times, double* out_amps,
                    int64_t* out_offsets) {
  int64_t k = 0;
  out_offsets[0] = 0;
  for (int64_t e = 0; e < n_events; ++e) {
    for (int b = 0; b < nblocks; ++b) {
      const int64_t lane = e * nblocks + b;
      const int np = npulse[lane];
      const double* t = times + lane * maxp;
      const double* a = amps + lane * maxp;
      for (int p = 0; p < np; ++p) {
        out_times[k] = t[p];
        out_amps[k] = a[p];
        ++k;
      }
    }
    out_offsets[e + 1] = k;
  }
}

}  // extern "C"

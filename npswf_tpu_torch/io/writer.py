# Copied from npswf_tpu/io/writer.py; tests/test_torch_host.py pins it there.
"""WF output writer: ragged flattening, ordered merge, persistence.

Equivalent of the reference's output layer (component C14/C3):
- the flattened ``wfampl``/``wftime`` layout indexed by ``wfnpulse``
  (ref TEST_2.C:585-587, 1289-1296; README.md:127): per event, each block's
  pulses concatenated in block order,
- the (runnum, evt) ordered index restoring the MT-shuffled event order
  (``BuildIndex`` at ref :1410-1422) — here a stored ``sort_order`` array,
- the FastCloneAndFilter equivalent (ref :88-122): opaque payload arrays from
  the input segment are carried into the output file, minus the raw stream,
- the h1time/h2time booked histograms (ref :533-534, 1369-1370), accumulated
  over all events.

Output container is a single .npz with the 17 Snapshot columns
(ref :1387) plus histograms and the index.
"""
from __future__ import annotations

import ctypes
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.io import native

# h1time: 200 bins in [-50, 50); h2time: 200 bins in [-100, 100) (ref :533-534)
H1_BINS, H1_LO, H1_HI = 200, -50.0, 50.0
H2_BINS, H2_LO, H2_HI = 200, -100.0, 100.0

# per-event column schema (name -> dtype): the 17 reference Snapshot columns
# plus the documented Samp* extras. A zero-event run must still emit every
# column so downstream readers (plotstats, parity) see the full schema.
WF_COLUMNS = {
    "wftime_flat": np.float64, "wfampl_flat": np.float64,
    "h1time_flat": np.float64, "h2time_flat": np.float64,
    "chi2": np.float64, "ampl": np.float64, "amplwf": np.float64,
    "wfnpulse": np.int32, "timewf": np.float64, "pedwf": np.float64,
    "enertot": np.float64, "integtot": np.float64, "pres": np.int32,
    "corr_time_HMS": np.float64, "Sampampl": np.float64,
    "Samptime": np.float64, "Sampener": np.float64, "Sampped": np.float64,
    "evt": np.int64, "runnum": np.int64,
    # per-block search-capacity overflow flag (1 = present block that lost
    # its search slot; its wfnpulse==0 is a capacity artifact, not physics)
    "search_overflow": np.int8,
}


def flatten_pulses_np(npulse: np.ndarray, times: np.ndarray, amps: np.ndarray):
    """numpy fallback for the ragged flatten. [E,B] i32, [E,B,P] -> flat."""
    E, B, P = times.shape
    mask = np.arange(P)[None, None, :] < npulse[:, :, None]
    out_t = times[mask]
    out_a = amps[mask]
    counts = npulse.sum(axis=1)
    offsets = np.zeros(E + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return out_t, out_a, offsets


def flatten_pulses(npulse: np.ndarray, times: np.ndarray, amps: np.ndarray):
    """Ragged flatten via the native library when available."""
    lib = native.load()
    E, B, P = times.shape
    if lib is None:
        return flatten_pulses_np(npulse, times, amps)
    npulse_c = np.ascontiguousarray(npulse, np.int32)
    t_c = np.ascontiguousarray(times, np.float64)
    a_c = np.ascontiguousarray(amps, np.float64)
    total = int(npulse_c.sum())
    out_t = np.empty(total, np.float64)
    out_a = np.empty(total, np.float64)
    offsets = np.empty(E + 1, np.int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.flatten_pulses(
        npulse_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_c.ctypes.data_as(f64p), a_c.ctypes.data_as(f64p),
        E, B, P, out_t.ctypes.data_as(f64p), out_a.ctypes.data_as(f64p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out_t, out_a, offsets


@dataclass
class WFWriter:
    """Accumulates pipeline batches; finalize() writes the ordered WF file."""
    cfg: NPSConfig
    payload: Dict[str, np.ndarray] = field(default_factory=dict)
    _cols: Dict[str, List[np.ndarray]] = field(default_factory=dict)
    _h1: np.ndarray = field(default_factory=lambda: np.zeros(H1_BINS, np.int64))
    _h2: np.ndarray = field(default_factory=lambda: np.zeros(H2_BINS, np.int64))
    n_fit_success: int = 0
    n_fit_failure: int = 0
    n_fit_dropped: int = 0
    # runtime-guard tallies (the reference's inline warnings, surfaced as
    # counters: bad slot ref :867-872, Ndata oversize ref :830-836, truncated
    # stream, high pulse count ref :209-213)
    n_bad_slot: int = 0
    n_oversize: int = 0
    n_truncated: int = 0
    n_high_pulse: int = 0
    n_search_dropped: int = 0

    def _append(self, name: str, arr: np.ndarray) -> None:
        self._cols.setdefault(name, []).append(np.asarray(arr))

    def add_batch(self, out, decoded, n_valid: Optional[int] = None) -> None:
        """Add a PipelineOutput + DecodedBatch (host numpy views).

        ``n_valid`` trims padding events appended to fill a fixed batch shape.
        """
        n = n_valid if n_valid is not None else np.asarray(out.wfnpulse).shape[0]
        npulse = np.asarray(out.wfnpulse)[:n]
        wftime = np.asarray(out.wftime, np.float64)[:n]
        wfampl = np.asarray(out.wfampl, np.float64)[:n]
        ft, fa, offs = flatten_pulses(npulse, wftime, wfampl)
        self._append("wftime_flat", ft)
        self._append("wfampl_flat", fa)
        self._append("wf_counts", np.diff(offs))

        h1 = np.asarray(out.h1time, np.float64)[:n]
        h2 = np.asarray(out.h2time, np.float64)[:n]
        hm = np.asarray(out.h_mask)[:n]
        hc = hm.reshape(n, -1).sum(axis=(1,)).astype(np.int64)
        self._append("h1time_flat", h1[hm])
        self._append("h2time_flat", h2[hm])
        self._append("h_counts", hc)
        if hm.any():
            self._h1 += np.histogram(h1[hm], bins=H1_BINS, range=(H1_LO, H1_HI))[0]
            self._h2 += np.histogram(h2[hm], bins=H2_BINS, range=(H2_LO, H2_HI))[0]

        self._append("chi2", np.asarray(out.chi2, np.float64)[:n])
        self._append("ampl", np.asarray(out.ampl, np.float64)[:n])
        self._append("amplwf", np.asarray(out.amplwf, np.float64)[:n])
        self._append("wfnpulse", npulse.astype(np.int32))
        self._append("timewf", np.asarray(out.timewf, np.float64)[:n])
        self._append("pedwf", np.asarray(out.pedwf, np.float64)[:n])
        self._append("enertot", np.asarray(out.enertot, np.float64)[:n])
        self._append("integtot", np.asarray(out.integtot, np.float64)[:n])
        B = self.cfg.nblocks
        self._append("pres", np.asarray(decoded.pres[:n, :B], np.int32))
        so = getattr(out, "search_overflow", None)
        self._append("search_overflow",
                     np.zeros((n, B), np.int8) if so is None
                     else np.asarray(so, np.int8)[:n])
        self._append("corr_time_HMS", np.asarray(decoded.corr_time_HMS)[:n])
        self._append("Sampampl", np.asarray(decoded.sampampl)[:n])
        self._append("Samptime", np.asarray(decoded.samptime)[:n])
        self._append("Sampener", np.asarray(decoded.sampener)[:n])
        self._append("Sampped", np.asarray(decoded.sampped)[:n])
        self._append("evt", np.asarray(decoded.evt)[:n])
        self._append("runnum", np.asarray(decoded.runnum)[:n])
        self.n_fit_success += int(out.n_fit_success)
        self.n_fit_failure += int(out.n_fit_failure)
        self.n_fit_dropped += int(out.n_fit_dropped)
        self.n_high_pulse += int(getattr(out, "n_high_pulse", 0))
        self.n_search_dropped += int(getattr(out, "n_search_dropped", 0))
        bad = np.asarray(decoded.bad_slot)[:n]
        self.n_bad_slot += int(np.sum(bad >= 0))
        self.n_oversize += int(np.sum(bad == -3))
        self.n_truncated += int(np.sum(bad == -2))

    def add_packet(self, pkt, decoded, n_valid: Optional[int] = None) -> None:
        """Add a host-side WriterPacket (device-flattened PipelineOutput).

        Column-equivalent to ``add_batch``: the ragged flatten already
        happened on device (``engine.pipeline.pack_for_writer``); this
        slices the fixed-capacity flat buffers by the true counts. The
        caller must have checked ``n_wf``/``n_h`` <= capacity (the executor
        falls back to ``add_batch`` on overflow).
        """
        npulse_full = np.asarray(pkt.wfnpulse)
        n = n_valid if n_valid is not None else npulse_full.shape[0]
        npulse = npulse_full[:n]
        wf_counts = np.asarray(pkt.wf_counts_e, np.int64)
        h_counts = np.asarray(pkt.h_counts_e, np.int64)
        # flatten order is event-major, so the first sum(counts[:n]) flat
        # entries belong to the first n events (padding events count 0)
        n_wf = int(wf_counts[:n].sum())
        n_h = int(h_counts[:n].sum())
        self._append("wftime_flat", np.asarray(pkt.wftime_flat,
                                               np.float64)[:n_wf])
        self._append("wfampl_flat", np.asarray(pkt.wfampl_flat,
                                               np.float64)[:n_wf])
        self._append("wf_counts", wf_counts[:n])
        h1 = np.asarray(pkt.h1time_flat, np.float64)[:n_h]
        h2 = np.asarray(pkt.h2time_flat, np.float64)[:n_h]
        self._append("h1time_flat", h1)
        self._append("h2time_flat", h2)
        self._append("h_counts", h_counts[:n])
        if n_h:
            self._h1 += np.histogram(h1, bins=H1_BINS, range=(H1_LO, H1_HI))[0]
            self._h2 += np.histogram(h2, bins=H2_BINS, range=(H2_LO, H2_HI))[0]

        self._append("chi2", np.asarray(pkt.chi2, np.float64)[:n])
        self._append("ampl", np.asarray(pkt.ampl, np.float64)[:n])
        self._append("amplwf", np.asarray(pkt.amplwf, np.float64)[:n])
        self._append("wfnpulse", npulse.astype(np.int32))
        self._append("timewf", np.asarray(pkt.timewf, np.float64)[:n])
        self._append("pedwf", np.asarray(pkt.pedwf, np.float64)[:n])
        self._append("enertot", np.asarray(pkt.enertot, np.float64)[:n])
        self._append("integtot", np.asarray(pkt.integtot, np.float64)[:n])
        B = self.cfg.nblocks
        self._append("pres", np.asarray(decoded.pres[:n, :B], np.int32))
        self._append("search_overflow",
                     np.asarray(pkt.search_overflow, np.int8)[:n])
        self._append("corr_time_HMS", np.asarray(decoded.corr_time_HMS)[:n])
        self._append("Sampampl", np.asarray(decoded.sampampl)[:n])
        self._append("Samptime", np.asarray(decoded.samptime)[:n])
        self._append("Sampener", np.asarray(decoded.sampener)[:n])
        self._append("Sampped", np.asarray(decoded.sampped)[:n])
        self._append("evt", np.asarray(decoded.evt)[:n])
        self._append("runnum", np.asarray(decoded.runnum)[:n])
        self.n_fit_success += int(pkt.n_fit_success)
        self.n_fit_failure += int(pkt.n_fit_failure)
        self.n_fit_dropped += int(pkt.n_fit_dropped)
        self.n_high_pulse += int(pkt.n_high_pulse)
        self.n_search_dropped += int(pkt.n_search_dropped)
        bad = np.asarray(decoded.bad_slot)[:n]
        self.n_bad_slot += int(np.sum(bad >= 0))
        self.n_oversize += int(np.sum(bad == -3))
        self.n_truncated += int(np.sum(bad == -2))

    def ingest_part(self, part: Dict[str, np.ndarray]) -> None:
        """Re-ingest a previously finalized (single-batch) part file's columns
        — used by the executor's checkpointed part/merge flow."""
        for k, v in part.items():
            if k in ("sort_order", "h1time_hist", "h2time_hist") or \
                    k.startswith("payload_"):
                continue
            if k == "fit_counters":
                self.n_fit_success += int(v[0])
                self.n_fit_failure += int(v[1])
                self.n_fit_dropped += int(v[2])
                if v.shape[0] > 3:   # guard counters (added in round 2)
                    self.n_bad_slot += int(v[3])
                    self.n_oversize += int(v[4])
                    self.n_truncated += int(v[5])
                    self.n_high_pulse += int(v[6])
                if v.shape[0] > 7:   # search-capacity counter
                    self.n_search_dropped += int(v[7])
            elif k == "wf_offsets":
                self._append("wf_counts", np.diff(v))
            elif k == "h_offsets":
                self._append("h_counts", np.diff(v))
            else:
                self._append(k, v)
        self._h1 += part["h1time_hist"]
        self._h2 += part["h2time_hist"]

    def finalize(self, path: str, compress: bool = True) -> Dict[str, np.ndarray]:
        cols = {k: np.concatenate(v) if v else np.zeros(0)
                for k, v in self._cols.items()}
        # zero-event runs: emit the full (empty) schema so readers work
        for name, dt in WF_COLUMNS.items():
            if name not in cols:
                cols[name] = np.zeros(0, dt)
        E = cols["evt"].shape[0]
        for key in ("wf", "h"):
            counts = cols.pop(f"{key}_counts", np.zeros(E, np.int64))
            offs = np.zeros(E + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            cols[f"{key}_offsets"] = offs
        # BuildIndex("runnum","evt") equivalent (ref :1410): a stable
        # (runnum, evt)-ordered permutation of the stored rows.
        cols["sort_order"] = np.lexsort((cols["evt"], cols["runnum"]))
        cols["h1time_hist"] = self._h1
        cols["h2time_hist"] = self._h2
        cols["fit_counters"] = np.array(
            [self.n_fit_success, self.n_fit_failure, self.n_fit_dropped,
             self.n_bad_slot, self.n_oversize, self.n_truncated,
             self.n_high_pulse, self.n_search_dropped], np.int64)
        for k, v in self.payload.items():
            cols[f"payload_{k}"] = v
        # part files are transient (deleted after the merge): the executor
        # writes them uncompressed — single-core DEFLATE would throttle the
        # whole job (PERF.md, end-to-end section)
        (np.savez_compressed if compress else np.savez)(path, **cols)
        return cols


def write_empty_wf(path: str,
                   payload: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, np.ndarray]:
    """Write a zero-event WF file carrying the full column schema.

    Used for empty runs/merges so downstream readers (plotstats, parity,
    diagnostics) still find every column — the reference's Snapshot always
    writes the full 17-branch schema even for empty trees (ref
    TEST_2.C:1383-1387)."""
    cols: Dict[str, np.ndarray] = {
        name: np.zeros(0, dt) for name, dt in WF_COLUMNS.items()}
    cols["wf_offsets"] = np.zeros(1, np.int64)
    cols["h_offsets"] = np.zeros(1, np.int64)
    cols["sort_order"] = np.zeros(0, np.int64)
    cols["h1time_hist"] = np.zeros(H1_BINS, np.int64)
    cols["h2time_hist"] = np.zeros(H2_BINS, np.int64)
    cols["fit_counters"] = np.zeros(8, np.int64)
    for k, v in (payload or {}).items():
        cols[f"payload_{k}"] = np.asarray(v)
    np.savez_compressed(path, **cols)
    return cols


def read_wf(path: str) -> Dict[str, np.ndarray]:
    z = np.load(path)
    return {k: z[k] for k in z.files}


def iter_events_sorted(wf: Dict[str, np.ndarray]):
    """Replay events through the stored index (the TTreeIndex pattern the
    reference documents for consumers, README.md:135-161)."""
    order = wf["sort_order"]
    offs = wf["wf_offsets"]
    for row in order:
        yield {
            "evt": wf["evt"][row],
            "runnum": wf["runnum"][row],
            "wfnpulse": wf["wfnpulse"][row],
            "chi2": wf["chi2"][row],
            "wftime": wf["wftime_flat"][offs[row]:offs[row + 1]],
            "wfampl": wf["wfampl_flat"][offs[row]:offs[row + 1]],
        }

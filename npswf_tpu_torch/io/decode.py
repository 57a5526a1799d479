# Copied from npswf_tpu/io/decode.py; tests/test_torch_host.py pins it there.
"""Batch decode: raw segments -> dense host arrays ready for upload.

Host-side stage of the pipeline (components C7/C12 of the reference,
TEST_2.C:854-939): the variable-length stream unpack runs in native C++
(io/native/decode.cpp), or in numpy when the caller asks for it
(``use_native=False``), and the hcana-derived HMS timing correction +
best-pulse selection runs vectorized in numpy.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.calibration import CalibrationBundle
from npswf_tpu_torch.golden.reference import decode_event_golden
from npswf_tpu_torch.io import native
from npswf_tpu_torch.io.rawstream import RawSegment


@dataclass
class DecodedBatch:
    signal: np.ndarray        # [E, B, T] f32
    pres: np.ndarray          # [E, nslots] u8
    minsignal: np.ndarray     # [E, B] f32
    bad_slot: np.ndarray      # [E] i32 (-1 = clean decode)
    corr_time_HMS: np.ndarray  # [E] f64
    sampampl: np.ndarray      # [E, B] f64
    samptime: np.ndarray      # [E, B] f64
    sampener: np.ndarray      # [E, B] f64
    sampped: np.ndarray       # [E, B] f64
    hcana_npulse: np.ndarray  # [E, B] f64
    evt: np.ndarray           # [E]
    runnum: np.ndarray        # [E]


def _decode_numpy(cfg: NPSConfig, seg: RawSegment, lo: int, hi: int):
    E = hi - lo
    B, T = cfg.nblocks, cfg.ntime
    signal = np.zeros((E, B, T), np.float32)
    pres = np.zeros((E, cfg.nslots), np.uint8)
    minsig = np.full((E, B), 1e6, np.float32)
    bad = np.full(E, -1, np.int32)
    for i in range(E):
        s, p, m, b = decode_event_golden(cfg, seg.event_stream(lo + i))
        signal[i] = s
        pres[i] = p
        minsig[i] = m
        bad[i] = b
    return signal, pres, minsig, bad


def _decode_native(cfg: NPSConfig, seg: RawSegment, lo: int, hi: int,
                   lib, n_threads: int):
    E = hi - lo
    B, T = cfg.nblocks, cfg.ntime
    so = seg.stream_offsets
    stream = np.ascontiguousarray(seg.stream[so[lo]:so[hi]], np.float64)
    offsets = np.ascontiguousarray(so[lo:hi + 1] - so[lo], np.int64)
    signal = np.empty((E, B, T), np.float32)
    pres = np.empty((E, cfg.nslots), np.uint8)
    minsig = np.empty((E, B), np.float32)
    bad = np.empty(E, np.int32)
    lib.decode_batch(
        stream.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        E, B, T, cfg.nslots, cfg.scint_slot_a, cfg.scint_slot_b,
        cfg.ndata_max,
        signal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pres.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        minsig.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads)
    return signal, pres, minsig, bad


def hms_corrections(cfg: NPSConfig, cal: CalibrationBundle, seg: RawSegment,
                    lo: int, hi: int):
    """Vectorized HMS correction + best-Samp* selection (ref :893-939)."""
    E = hi - lo
    B = cfg.nblocks
    corr = np.zeros(E)
    sampampl = np.full((E, B), -100.0)
    samptime = np.full((E, B), -100.0)
    sampener = np.full((E, B), -100.0)
    sampped = np.full((E, B), -100.0)
    npulse = np.zeros((E, B))
    ho = seg.hit_offsets
    for i in range(E):
        s, e = ho[lo + i], ho[lo + i + 1]
        if e <= s:
            continue
        c = seg.adc_counter[s:e].astype(np.int64)
        c = np.where(c == cfg.scint_slot_a, B, c)
        c = np.where(c == cfg.scint_slot_b, B + 1, c)
        pt = seg.pulse_time[s:e]
        ptr = seg.pulse_time_raw[s:e]
        off = cal.tdcoffset[c[0]] if 0 <= c[0] < B else 0.0
        corr[i] = pt[0] - ptr[0] / 16.0 - off
        ok = (c >= 0) & (c < B)
        idx = c[ok]
        tm2 = cal.timemean2[idx]
        dist = np.abs(pt[ok] - tm2)
        # best hit per block: minimal |time - timemean2|, first on tie
        # (the reference's sequential strict-> replacement, ref :928-937)
        order = np.lexsort((np.arange(idx.size), dist, idx))
        sidx = idx[order]
        first = np.ones(sidx.size, bool)
        first[1:] = sidx[1:] != sidx[:-1]
        chosen = order[first]
        hb = idx[chosen]
        hit_rows = np.nonzero(ok)[0][chosen]
        sampampl[i, hb] = seg.pulse_amp[s:e][hit_rows]
        samptime[i, hb] = pt[hit_rows]
        sampener[i, hb] = seg.pulse_int[s:e][hit_rows]
        sampped[i, hb] = seg.pulse_ped[s:e][hit_rows]
        np.add.at(npulse[i], idx, 1.0)
    return corr, sampampl, samptime, sampener, sampped, npulse


def decode_raw(cfg: NPSConfig, seg: RawSegment, lo: int = 0,
               hi: Optional[int] = None, use_native: bool = True,
               n_threads: int = 0):
    """Raw-stream decode only (no calibration-dependent HMS stage).

    Returns (signal [E,B,T] f32, pres [E,nslots] u8, minsignal [E,B] f32,
    bad_slot [E] i32). Used by decode_segment and by calibration-free
    consumers (e.g. tools/extract_templates.py, which runs before any
    CalibrationBundle exists)."""
    hi = seg.n_events if hi is None else hi
    lib = native.load() if use_native else None
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    if lib is not None:
        return _decode_native(cfg, seg, lo, hi, lib, n_threads)
    return _decode_numpy(cfg, seg, lo, hi)


def decode_segment(cfg: NPSConfig, cal: CalibrationBundle, seg: RawSegment,
                   lo: int = 0, hi: Optional[int] = None,
                   use_native: bool = True,
                   n_threads: int = 0) -> DecodedBatch:
    """Decode events [lo, hi) of a segment into a dense batch."""
    hi = seg.n_events if hi is None else hi
    signal, pres, minsig, bad = decode_raw(cfg, seg, lo, hi,
                                           use_native=use_native,
                                           n_threads=n_threads)
    corr, sampampl, samptime, sampener, sampped, hn = hms_corrections(
        cfg, cal, seg, lo, hi)
    return DecodedBatch(signal=signal, pres=pres, minsignal=minsig, bad_slot=bad,
                        corr_time_HMS=corr, sampampl=sampampl, samptime=samptime,
                        sampener=sampener, sampped=sampped, hcana_npulse=hn,
                        evt=seg.evt[lo:hi], runnum=seg.runnum[lo:hi])

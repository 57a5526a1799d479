"""Frozen host decode of a raw segment: the stream unpack and the HMS
correction with the best-hit selection, in numpy.

Copied from npswf_tpu_torch/golden/reference.py::decode_event_golden and
npswf_tpu_torch/io/decode.py::hms_corrections (the numpy versions the
port's native decoder is held to). ``decode(g, cal, seg, lo, hi)`` returns
the arrays the WF file's decode columns hold and the batch the pipeline is
given, by the port's DecodedBatch names.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def decode_event(g, stream: np.ndarray):
    B, T = g.nblocks, g.ntime
    signal = np.zeros((B, T))
    pres = np.zeros(g.nslots, dtype=np.int32)
    minsignal = np.full(B, 1e6)
    ns = 0
    n = stream.shape[0]
    bad = -1
    if n > g.nslots * (g.ntime + 2):
        return signal, pres, minsignal, -3
    while ns + 2 <= n:
        bloc = int(stream[ns])
        ns += 1
        nsamp = int(stream[ns])
        ns += 1
        if bloc == g.scint_slot_a:
            bloc = 1080
        if bloc == g.scint_slot_b:
            bloc = 1081
        if bloc < 0 or bloc > g.nslots - 0.5:
            bad = bloc
            break
        pres[bloc] = 1
        if ns + nsamp > n:
            bad = -2
        lim = min(nsamp, T, n - ns)
        if 0 <= bloc < B:
            for it in range(lim):
                signal[bloc, it] = stream[ns + it]
                minsignal[bloc] = min(minsignal[bloc], signal[bloc, it])
        ns += nsamp
    return signal, pres, minsignal, bad


def hms_corrections(g, cal: Dict[str, np.ndarray], seg: Dict[str, np.ndarray],
                    lo: int, hi: int):
    E = hi - lo
    B = g.nblocks
    corr = np.zeros(E)
    sampampl = np.full((E, B), -100.0)
    samptime = np.full((E, B), -100.0)
    sampener = np.full((E, B), -100.0)
    sampped = np.full((E, B), -100.0)
    npulse = np.zeros((E, B))
    ho = seg["hit_offsets"]
    for i in range(E):
        s, e = ho[lo + i], ho[lo + i + 1]
        if e <= s:
            continue
        c = seg["adc_counter"][s:e].astype(np.int64)
        c = np.where(c == g.scint_slot_a, B, c)
        c = np.where(c == g.scint_slot_b, B + 1, c)
        pt = seg["pulse_time"][s:e]
        ptr = seg["pulse_time_raw"][s:e]
        off = cal["tdcoffset"][c[0]] if 0 <= c[0] < B else 0.0
        corr[i] = pt[0] - ptr[0] / 16.0 - off
        ok = (c >= 0) & (c < B)
        idx = c[ok]
        tm2 = cal["timemean2"][idx]
        dist = np.abs(pt[ok] - tm2)
        order = np.lexsort((np.arange(idx.size), dist, idx))
        sidx = idx[order]
        first = np.ones(sidx.size, bool)
        first[1:] = sidx[1:] != sidx[:-1]
        chosen = order[first]
        hb = idx[chosen]
        hit_rows = np.nonzero(ok)[0][chosen]
        sampampl[i, hb] = seg["pulse_amp"][s:e][hit_rows]
        samptime[i, hb] = pt[hit_rows]
        sampener[i, hb] = seg["pulse_int"][s:e][hit_rows]
        sampped[i, hb] = seg["pulse_ped"][s:e][hit_rows]
        np.add.at(npulse[i], idx, 1.0)
    return corr, sampampl, samptime, sampener, sampped, npulse


def decode(g, cal: Dict[str, np.ndarray], seg: Dict[str, np.ndarray], lo: int,
           hi: int) -> Dict[str, np.ndarray]:
    """Events [lo, hi) of the segment: signal [E, B, T] f32, pres [E, nslots]
    u8, minsignal [E, B] f32, bad_slot [E], corr_time_HMS [E], Samp*
    [E, B], evt, runnum."""
    E = hi - lo
    B, T = g.nblocks, g.ntime
    signal = np.zeros((E, B, T), np.float32)
    pres = np.zeros((E, g.nslots), np.uint8)
    minsig = np.full((E, B), 1e6, np.float32)
    bad = np.full(E, -1, np.int32)
    so = seg["stream_offsets"]
    for i in range(E):
        s, p, m, b = decode_event(g, seg["stream"][so[lo + i]:so[lo + i + 1]])
        signal[i] = s
        pres[i] = p
        minsig[i] = m
        bad[i] = b
    corr, sa, st, se, sp, _ = hms_corrections(g, cal, seg, lo, hi)
    return dict(signal=signal, pres=pres, minsignal=minsig, bad_slot=bad,
                corr_time_HMS=corr, Sampampl=sa, Samptime=st, Sampener=se,
                Sampped=sp, evt=seg["evt"][lo:hi], runnum=seg["runnum"][lo:hi])

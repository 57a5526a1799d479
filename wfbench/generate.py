"""The benchmark's traffic and calibration, made from ``--seed`` (numpy only).

Frozen copies of the port's generators, so that a later change of the
program cannot move the yardstick:

- ``synthetic_calibration`` (and ``synthetic_pulse_shape``,
  ``natural_cubic_spline_coeffs``, ``_derive_block``): copied from
  npswf_tpu_torch/core/calibration.py;
- ``make_events``: npswf_tpu_torch/utils/synthetic.py (its draws in its
  order, the pulse shapes added in one vectorized step);
- ``synth_records``: npswf_tpu_torch/tools/cli.py;
- ``encode_event_stream``, ``build_segment``: npswf_tpu_torch/io/rawstream.py
  (returning plain dicts).

``wfbench/tests/test_wfbench_generate.py`` holds each to its original on
the same seed. ``make_traffic`` reads a traffic file's parameters; each
chunk of 64 events (a batch of the pool, or a chunk of the segment) draws
from its own stream, ``default_rng([seed, stream, index])``, and the chunks
are built in spawned worker processes, which end before it returns.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# streams of the seed: the calibration, the events of chunk i, the hcana
# hits of chunk i, the per-event HMS correction of batch i
CALIB, EVENTS, HITS, CORR = 0, 1, 2, 3


def seed_key(seed: int, stream: int, index: int = 0):
    """The numpy seed of one stream of ``--seed`` (any whole number)."""
    return [int(seed) % (1 << 64), stream, index]


# ----------------------------------------------------------------------
# calibration (core/calibration.py)
# ----------------------------------------------------------------------
def natural_cubic_spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 3:
        raise ValueError("need at least 3 knots")
    h = np.diff(x)
    if np.any(h <= 0):
        raise ValueError("knots must be strictly increasing")
    rhs = 6.0 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    diag = 2.0 * (h[:-1] + h[1:])
    lower = h[:-1].copy()
    upper = h[1:].copy()
    m = n - 2
    cp = np.zeros(m)
    dp = np.zeros(m)
    cp[0] = upper[0] / diag[0]
    dp[0] = rhs[0] / diag[0]
    for i in range(1, m):
        denom = diag[i] - lower[i] * cp[i - 1]
        cp[i] = upper[i] / denom if i < m - 1 else 0.0
        dp[i] = (rhs[i] - lower[i] * dp[i - 1]) / denom
    M = np.zeros(n)
    if m > 0:
        M[m] = dp[m - 1]
        for i in range(m - 2, -1, -1):
            M[i + 1] = dp[i] - cp[i] * M[i + 2]
    a = y[:-1]
    b = (y[1:] - y[:-1]) / h - h * (2.0 * M[:-1] + M[1:]) / 6.0
    c = M[:-1] / 2.0
    d = (M[1:] - M[:-1]) / (6.0 * h)
    return np.stack([a, b, c, d], axis=-1)


def synthetic_pulse_shape(g, peak_bin: float = 40.0, rise: float = 2.5,
                          decay: float = 8.0) -> np.ndarray:
    t = np.arange(g.ntime, dtype=np.float64)
    u = (t - (peak_bin - rise * 3.0)) / rise
    shape = np.where(u > 0, (u ** 2) * np.exp(-u * rise / decay), 0.0)
    m = shape.max()
    return shape / m if m > 0 else shape


def _derive_block(g, xs: np.ndarray, ys: np.ndarray):
    imax = int(np.argmax(ys))
    timeref = float(xs[imax])
    idx = np.clip(np.arange(g.mfwidth) + imax - g.mfleft, 0, g.ntime - 1)
    mfyref = ys[idx]
    mfint = float(np.sum(mfyref))
    kern_rev = mfyref[::-1].copy()
    coeffs = natural_cubic_spline_coeffs(xs, ys)
    return timeref, kern_rev, mfint, coeffs


def synthetic_calibration(g, run: int = 3000, seed=0,
                          peak_jitter: float = 1.5) -> Dict[str, np.ndarray]:
    """The calibration arrays of ``CalibrationBundle`` (same names)."""
    rng = np.random.default_rng(seed)
    B, T = g.nblocks, g.ntime
    interp_x = np.tile(np.arange(T, dtype=np.float64), (B, 1))
    interp_y = np.zeros((B, T))
    timeref = np.zeros(B)
    mfkern_rev = np.zeros((B, g.mfwidth))
    mfint = np.ones(B)
    spline_coeffs = np.zeros((B, T - 1, 4))
    spline_x0 = np.zeros(B)
    peaks = 40.0 + peak_jitter * rng.standard_normal(B)
    rises = 2.5 + 0.2 * rng.standard_normal(B)
    decays = 8.0 + 0.5 * rng.standard_normal(B)
    for b in range(B):
        ys = synthetic_pulse_shape(g, peaks[b], abs(rises[b]) + 0.5,
                                   abs(decays[b]) + 1.0)
        interp_y[b] = ys
        tr, kr, mi, co = _derive_block(g, interp_x[b], ys)
        timeref[b] = tr
        mfkern_rev[b] = kr
        mfint[b] = mi
        spline_coeffs[b] = co
        spline_x0[b] = interp_x[b, 0]
    timerefacc = g.timerefacc()
    return dict(
        interp_x=interp_x, interp_y=interp_y, timeref=timeref,
        preswf=np.ones(B, dtype=bool), mfkern_rev=mfkern_rev, mfint=mfint,
        tdcoffset=0.1 * rng.standard_normal(B),
        cortime=np.where(rng.random(B) < 0.02, -1.0e-7,
                         0.5 * rng.standard_normal(B)),
        timerefacc=timerefacc,
        timemean2=np.full(B, g.timemean_base + timerefacc * g.dt),
        spline_coeffs=spline_coeffs, spline_x0=spline_x0, run=run)


# ----------------------------------------------------------------------
# events (utils/synthetic.py)
# ----------------------------------------------------------------------
def make_events(g, cal: dict, n_events: int, occupancy: float = 0.05,
                max_pulses: int = 2, noise: float = 0.5,
                amp_range: Tuple[float, float] = (20.0, 200.0),
                time_jitter: float = 3.0,
                pedestal_range: Tuple[float, float] = (-5.0, 5.0),
                seed=0, pileup_prob: float = 0.3) -> Dict[str, np.ndarray]:
    """Signal [E, B, T] f64, pres, npulse, times, amps, pedestal.

    The port's draws in the port's order, block by block; the pulse shapes
    are then added in one vectorized step, each block's pulses in their
    order, which gives the port's signal bit for bit in a fraction of its
    time (its loop evaluated the spline once a pulse)."""
    rng = np.random.default_rng(seed)
    E, B, T = n_events, g.nblocks, g.ntime
    Pmax = max(1, max_pulses)
    signal = np.zeros((E, B, T))
    pres = np.ones((E, B), dtype=np.int32)
    npulse = np.zeros((E, B), dtype=np.int32)
    times = np.zeros((E, B, Pmax))
    amps = np.zeros((E, B, Pmax))
    pedestal = rng.uniform(*pedestal_range, size=(E, B))

    signal += pedestal[..., None]
    if noise > 0:
        signal += noise * rng.standard_normal((E, B, T))

    active = rng.random((E, B)) < occupancy
    timeref = cal["timeref"]
    pulses = []             # (event, block, slot, t0, a0) in draw order
    for e in range(E):
        for b in np.nonzero(active[e])[0]:
            k = 1
            if max_pulses > 1 and rng.random() < pileup_prob:
                k = rng.integers(2, max_pulses + 1)
            tr = timeref[b]
            for p in range(k):
                dt0 = time_jitter * rng.standard_normal()
                if p > 0:
                    dt0 += rng.uniform(-30.0, 30.0)
                t0 = min(max(tr + dt0, 15.0), 95.0)    # np.clip's value
                a0 = rng.uniform(*amp_range)
                pulses.append((e, b, p, t0, a0))
            npulse[e, b] = k
    if pulses:
        ev = np.array([q[0] for q in pulses], np.int64)
        bl = np.array([q[1] for q in pulses], np.int64)
        sl = np.array([q[2] for q in pulses], np.int64)
        t0 = np.array([q[3] for q in pulses], np.float64)
        a0 = np.array([q[4] for q in pulses], np.float64)
        times[ev, bl, sl] = t0
        amps[ev, bl, sl] = a0
        x = np.arange(T, dtype=np.float64)
        arg = x[None, :] - (t0 - timeref[bl])[:, None]
        gate = (arg > g.spline_gate_lo) & (arg < T - 1)
        coeffs = cal["spline_coeffs"]
        x0 = cal["spline_x0"][bl][:, None]
        idx = np.clip(np.floor((arg - x0) / 1.0).astype(np.int64), 0,
                      coeffs.shape[1] - 1)
        u = arg - (x0 + idx * 1.0)
        a, b_, c, d = (coeffs[bl[:, None], idx, k] for k in range(4))
        vals = ((d * u + c) * u + b_) * u + a
        # unbuffered and in order: a block's pulses add one after another
        np.add.at(signal, (ev, bl), np.where(gate, a0[:, None] * vals, 0.0))
    return dict(signal=signal, pres=pres, npulse=npulse, times=times,
                amps=amps, pedestal=pedestal)


# ----------------------------------------------------------------------
# raw segments (io/rawstream.py, tools/cli.py)
# ----------------------------------------------------------------------
def encode_event_stream(g, signal: np.ndarray,
                        pres: Optional[np.ndarray] = None) -> np.ndarray:
    B, T = signal.shape
    if pres is None:
        pres = np.ones(B, dtype=bool)
    chunks: List[np.ndarray] = []
    for b in np.nonzero(pres)[0]:
        chunks.append(np.concatenate([[float(b), float(T)], signal[b]]))
    if not chunks:
        return np.zeros(0)
    return np.concatenate(chunks)


def synth_records(g, truth: dict, rng, pres=None):
    """Raw streams and hcana hit arrays of synthetic events."""
    pres = truth["pres"].astype(bool) if pres is None else pres
    streams, hits = [], []
    for e in range(truth["signal"].shape[0]):
        streams.append(encode_event_stream(g, truth["signal"][e], pres[e]))
        nb = np.nonzero(truth["npulse"][e])[0]
        hits.append({
            "adc_counter": nb.astype(np.float64),
            "pulse_time": truth["times"][e, nb, 0] * g.dt +
            rng.standard_normal(nb.size) * 0.1,
            "pulse_time_raw": rng.uniform(0, 4000, nb.size),
            "pulse_amp": truth["amps"][e, nb, 0],
            "pulse_int": truth["amps"][e, nb, 0] * 7.5,
            "pulse_ped": truth["pedestal"][e, nb]})
    return streams, hits


HIT_KEYS = ("adc_counter", "pulse_time", "pulse_time_raw", "pulse_amp",
            "pulse_int", "pulse_ped")


def build_segment(streams: List[np.ndarray], hits: List[Dict[str, np.ndarray]],
                  evt: np.ndarray, runnum: np.ndarray) -> Dict[str, np.ndarray]:
    """The fields of ``RawSegment`` (payload empty)."""
    so = np.zeros(len(streams) + 1, dtype=np.int64)
    np.cumsum([s.shape[0] for s in streams], out=so[1:])
    ho = np.zeros(len(hits) + 1, dtype=np.int64)
    np.cumsum([h["adc_counter"].shape[0] for h in hits], out=ho[1:])

    def cat(key):
        arrs = [h[key] for h in hits]
        return np.concatenate(arrs) if arrs else np.zeros(0)

    out = dict(stream=np.concatenate(streams) if streams else np.zeros(0),
               stream_offsets=so, hit_offsets=ho,
               evt=np.asarray(evt, np.float64),
               runnum=np.asarray(runnum, np.float64))
    out.update({k: cat(k) for k in HIT_KEYS})
    return out


# ----------------------------------------------------------------------
# a traffic file's traffic
# ----------------------------------------------------------------------
CHUNK = 64   # events a chunk (a batch of the pool, a chunk of the segment)


def _event_args(t: dict) -> dict:
    return dict(occupancy=t["occupancy"], max_pulses=t["max_pulses"],
                noise=t["noise"], amp_range=tuple(t["amp_range"]),
                time_jitter=t["time_jitter"],
                pedestal_range=tuple(t["pedestal_range"]),
                pileup_prob=t["pileup_prob"])


def _batch_chunk(job):
    """One batch of the pool: signal [E, B, T] f64, pres [E, B] bool and the
    HMS correction [E]."""
    fields, cal, t, seed, i, n = job
    from wfbench.spec import Geometry
    g = Geometry(fields)
    truth = make_events(g, cal, n, seed=seed_key(seed, EVENTS, i),
                        **_event_args(t))
    pres = truth["npulse"] > 0 if t["sparse_readout"] else \
        truth["pres"].astype(bool)
    lo, hi = t["corr_time_range"]
    corr = np.random.default_rng(seed_key(seed, CORR, i)).uniform(lo, hi, n)
    signal = truth["signal"]
    if fields["compute_dtype"] == "float32":
        # rounded here as the upload would round it; half the bytes to send
        signal = signal.astype(np.float32)
    return signal, pres, corr


def _segment_chunk(job):
    """Streams and hits of one chunk of the segment."""
    fields, cal, t, seed, i, n = job
    from wfbench.spec import Geometry
    g = Geometry(fields)
    truth = make_events(g, cal, n, seed=seed_key(seed, EVENTS, i),
                        **_event_args(t))
    rng = np.random.default_rng(seed_key(seed, HITS, i))
    return synth_records(g, truth, rng,
                         pres=truth["npulse"] > 0 if t["sparse_readout"]
                         else None)


def _map(fn, jobs, workers: int):
    """fn over jobs in spawned worker processes, each stopped and joined
    before this returns; in-process for one worker."""
    if workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(workers, len(jobs)))
    try:
        out = pool.map(fn, jobs)
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return out


def default_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def make_traffic(fields: dict, t: dict, seed: int,
                 workers: Optional[int] = None) -> dict:
    """The calibration and the traffic of a traffic file's parameters.

    ``process_batch`` mixes: ``batches``, a list of (signal, pres, corr) of
    ``events_per_call`` events each, ``pool`` of them. ``run_segment``
    mixes: ``segment``, the RawSegment fields of ``events`` events, built
    in chunks of 64 (evt numbered from ``first_evt``, run ``run``)."""
    from wfbench.spec import Geometry
    g = Geometry(fields)
    workers = default_workers() if workers is None else workers
    cal = synthetic_calibration(g, run=t.get("run", 3000),
                                seed=seed_key(seed, CALIB))
    if t["entry"] == "process_batch":
        E = t["events_per_call"]
        jobs = [(fields, cal, t, seed, i, E) for i in range(t["pool"])]
        return {"calibration": cal, "batches": _map(_batch_chunk, jobs, workers)}
    n = t["events"]
    jobs = [(fields, cal, t, seed, i, min(CHUNK, n - lo))
            for i, lo in enumerate(range(0, n, CHUNK))]
    parts = _map(_segment_chunk, jobs, workers)
    streams = [s for st, _ in parts for s in st]
    hits = [h for _, hs in parts for h in hs]
    first = t["first_evt"]
    seg = build_segment(streams, hits,
                        evt=np.arange(first, first + n, dtype=np.float64),
                        runnum=np.full(n, float(t["run"])))
    return {"calibration": cal, "segment": seg}

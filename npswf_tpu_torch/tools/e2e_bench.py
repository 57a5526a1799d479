"""End-to-end (host-I/O-inclusive) benchmark of ``run_segment`` on the card.

Ported from npswf_tpu/tools/e2e_bench.py (``build_tiled_segment`` is a copy,
pinned by tests/test_torch_host.py). It times the port's production path on
a synthetic segment tiled from 64 events,

    decode (C++ decoder) -> upload -> process_batch + writer packet on two
    stage workers -> ordered fetch -> uncompressed part files -> merge

and reports the segment's blocks/s next to a device-only measurement of
``process_batch`` on the segment's first batch in the same process, and the
executor's per-stage medians. The segment is held in memory (the reference
reads a page-cached ROOT file; the decode stage is the comparable work).

Usage:  python -m npswf_tpu_torch.tools.e2e_bench [--events 5120]
            [--mode both] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Tuple

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.calibration import CalibrationBundle, synthetic_calibration
from npswf_tpu_torch.io.rawstream import RawSegment, build_segment, encode_event_stream
from npswf_tpu_torch.utils.synthetic import make_events


def build_tiled_segment(cfg: NPSConfig, cal: CalibrationBundle,
                        n_events: int, occupancy: float,
                        sparse_readout: bool, base_events: int = 64,
                        seed: int = 7) -> Tuple[RawSegment, np.ndarray]:
    """A ``n_events`` segment tiled from ``base_events`` synthetic events.

    Tiling keeps host-side generation tractable (the per-event decode work
    is identical for repeated waveforms); event numbers stay unique.
    Returns (segment, base_pres) for sanity checks.
    """
    truth = make_events(cfg, cal, base_events, occupancy=occupancy,
                        max_pulses=2, pileup_prob=0.25, seed=seed)
    # real FADC streams carry integral ADC counts stored as doubles (ref
    # TEST_2.C:854-889); quantize the synthetic waveforms the same way so
    # the bench exercises the production uplink (lossless int16 route)
    truth.signal = np.rint(truth.signal)
    pres = (truth.npulse > 0) if sparse_readout else np.ones_like(
        truth.npulse, dtype=bool)
    rng = np.random.default_rng(seed + 1)
    streams, hits = [], []
    for e in range(base_events):
        streams.append(encode_event_stream(cfg, truth.signal[e],
                                           pres[e].astype(bool)))
        nb = np.nonzero(truth.npulse[e])[0]
        hits.append({
            "adc_counter": nb.astype(np.float64),
            "pulse_time": truth.times[e, nb, 0] * cfg.dt
            + rng.standard_normal(nb.size) * 0.1,
            "pulse_time_raw": rng.uniform(0, 4000, nb.size),
            "pulse_amp": truth.amps[e, nb, 0],
            "pulse_int": truth.amps[e, nb, 0] * 7.5,
            "pulse_ped": truth.pedestal[e, nb]})
    ntiles = (n_events + base_events - 1) // base_events
    streams = (streams * ntiles)[:n_events]
    hits = (hits * ntiles)[:n_events]
    seg = build_segment(
        cfg, streams, hits,
        evt=np.arange(n_events, dtype=np.float64),
        runnum=np.full(n_events, 3000, np.float64))
    return seg, pres


def measure_device_only(cfg: NPSConfig, cal: CalibrationBundle,
                        seg: RawSegment, batch_size: int, device) -> float:
    """Seconds a batch of ``process_batch`` on this segment's first batch,
    already on the device: the median of 8 calls after two warm-ups, each
    timed to the device's end (CUDA events on the card)."""
    import torch
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.engine.pipeline import process_batch
    from npswf_tpu_torch.io.decode import decode_segment
    from npswf_tpu_torch.runtime.executor import (_pad_decoded,
                                                  _to_event_batch, torch_dtype)
    from npswf_tpu_torch.utils.timing import device_seconds

    dtype = torch_dtype(cfg)
    d = _pad_decoded(cfg, decode_segment(cfg, cal, seg, 0, batch_size),
                     batch_size)
    batch = _to_event_batch(cfg, d, dtype, device)
    calib = calib_to_torch(cal.device_arrays(cfg), device, dtype)
    return device_seconds(lambda: process_batch(cfg, calib, batch), device,
                          reps=8, warmup=2)


def run_mode(cfg: NPSConfig, cal: CalibrationBundle, n_events: int,
             batch_size: int, mode: str, workdir: str, device,
             compress: bool = False, chain_batches: int = 4) -> dict:
    from npswf_tpu_torch.runtime.executor import run_segment
    from npswf_tpu_torch.utils.timers import StageTimer

    sparse = mode == "sparse"
    if sparse:
        cfg = cfg.replace(
            search_capacity=max(1024, batch_size * cfg.nblocks // 8))
    print(f"[{mode}] building {n_events}-event segment...", file=sys.stderr)
    seg, _ = build_tiled_segment(cfg, cal, n_events,
                                 occupancy=0.05 if sparse else 1.0,
                                 sparse_readout=sparse)
    print(f"[{mode}] segment stream: {seg.stream.nbytes / 1e9:.3f} GB",
          file=sys.stderr)

    dt_dev = measure_device_only(cfg, cal, seg, batch_size, device)
    dev_bps = batch_size * cfg.nblocks / dt_dev
    print(f"[{mode}] device-only: {dt_dev * 1e3:.3f} ms/batch = "
          f"{dev_bps:,.0f} blocks/s", file=sys.stderr)

    out_path = os.path.join(workdir, f"wf_{mode}.npz")
    timers = StageTimer()
    t0 = time.perf_counter()
    res = run_segment(cfg, cal, seg, out_path, batch_size=batch_size,
                      resume=False, timers=timers, progress_every=10 ** 9,
                      compress_output=compress, chain_batches=chain_batches,
                      device=device)
    wall = time.perf_counter() - t0
    e2e_bps = n_events * cfg.nblocks / wall
    # steady state: the median gap between batch completions
    med_gap = timers.median("interbatch")
    med_bps = (batch_size * cfg.nblocks / med_gap) if med_gap > 0 else 0.0
    print(f"[{mode}] end-to-end: {wall:.3f}s for {n_events} events = "
          f"{e2e_bps:,.0f} blocks/s ({e2e_bps / dev_bps:.1%} of device-only); "
          f"steady state (median batch period {med_gap * 1e3:.3f} ms): "
          f"{med_bps:,.0f} blocks/s", file=sys.stderr)
    print(f"[{mode}] {timers.report()}", file=sys.stderr)
    print(f"[{mode}] output: {os.path.getsize(out_path) / 1e6:.3f} MB, fits "
          f"ok={res.n_fit_success} fail={res.n_fit_failure}", file=sys.stderr)
    return {"mode": mode, "events": n_events,
            "e2e_blocks_per_sec": e2e_bps,
            "e2e_steady_blocks_per_sec": med_bps,
            "device_blocks_per_sec": dev_bps,
            "device_ms_per_batch": dt_dev * 1e3,
            "e2e_frac_of_device": e2e_bps / dev_bps,
            "wall_s": wall,
            "stage_medians_ms": {k: timers.median(k) * 1e3
                                 for k in sorted(timers.totals)},
            "stages_s": dict(timers.totals)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=5120)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--mode", choices=["dense", "sparse", "both"],
                    default="both")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--chain-batches", type=int, default=4,
                    help="batches a call, fetched as one stacked packet")
    ap.add_argument("--compress", action="store_true",
                    help="DEFLATE the final merged file (default: stored; "
                         "both are valid .npz)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)

    from npswf_tpu_torch.runtime.executor import resolve_device
    from npswf_tpu_torch.utils.timing import device_name, probe_config
    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device_name(device)}", file=sys.stderr)
    cfg = probe_config()
    cal = synthetic_calibration(cfg, seed=1)
    workdir = args.workdir or tempfile.mkdtemp(prefix="npswf_e2e_")
    results = []
    try:
        modes = ["dense", "sparse"] if args.mode == "both" else [args.mode]
        for m in modes:
            results.append(run_mode(cfg, cal, args.events, args.batch_size,
                                    m, workdir, device, compress=args.compress,
                                    chain_batches=args.chain_batches))
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

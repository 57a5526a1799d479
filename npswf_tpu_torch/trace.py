"""Where the time of ``process_batch`` goes on the card, route by route.

    python -m npswf_tpu_torch.trace [--batches 3] [--events 64]
                                    [--routes default,slice,fused_neq,fused_system]

On bench.py's dense batch (E events x 1080 blocks x 110 samples, fp32,
seeds 7 and 11, as chip_smoke.py builds it) each route runs once to warm
up, is timed untraced (host clock around synchronized batches, median of
3), then traced with ``torch.profiler`` over ``--batches`` batches. Per
route it prints the host ms a batch with and without the profiler, the
device busy ms a batch (the sum of the kernels' device times), the
device's idle share of the traced span, kernel launches a batch and the
kernels that take the most device time, beside the card's name and power
limit; the last line is the whole summary as JSON. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import process_batch
from npswf_tpu_torch.utils.synthetic import make_events

SLICE = dict(use_pallas_lm=False, pallas_search_select=True)
ROUTES = {"default": {}, "slice": SLICE,
          "fused_neq": dict(SLICE, use_fused_neq=True),
          "fused_system": dict(SLICE, use_fused_system=True)}


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "?"


def trace_route(cfg, calib, batch, n_batches: int, top: int = 8):
    E, B, _ = batch.signal.shape

    def one():
        process_batch(cfg, calib, batch)
        torch.cuda.synchronize()
    one()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        host.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            one()
        span_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            kernels.append((evt.key, us / 1e3 / n_batches, evt.count / n_batches))
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return {
        "host_ms": float(np.median(host)),
        "traced_host_ms": span_ms / n_batches,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy * n_batches / span_ms,
        "launches": sum(k[2] for k in kernels),
        "blocks_per_s": E * B / (float(np.median(host)) / 1e3),
        "top": [{"kernel": k[0][:80], "ms": k[1], "launches": k[2]}
                for k in kernels[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--events", type=int, default=64)
    ap.add_argument("--routes", default=",".join(ROUTES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = _card()
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, args.events, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    corr = np.random.default_rng(11).uniform(-2, 2, args.events)
    batch = batch_to_torch(truth.signal.astype(np.float32), truth.pres,
                           corr.astype(np.float32), dev, torch.float32)
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float32)
    summary = {"card": card, "events": args.events, "routes": {}}
    for route in args.routes.split(","):
        r = trace_route(cfg.replace(**ROUTES[route]), calib, batch,
                        args.batches)
        summary["routes"][route] = r
        print(f"[{route}] host {r['host_ms']:.3f} ms/batch untraced "
              f"({r['blocks_per_s']:.0f} blocks/s), {r['traced_host_ms']:.3f} "
              f"traced; device busy {r['device_busy_ms']:.3f} ms/batch, idle "
              f"{r['idle_share']:.1%} of the traced span; "
              f"{r['launches']:.0f} launches/batch ({card})", flush=True)
        for k in r["top"]:
            print(f"    {k['ms']:9.3f} ms {k['launches']:7.1f}x  {k['kernel']}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

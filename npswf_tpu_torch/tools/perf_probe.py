"""Dispatch-regime probes: the sync floor, a batch-size sweep, chain-k.

Ported from npswf_tpu/tools/perf_probe.py, a companion of
``tools/glue_profile.py`` (which itemizes stage costs): these measure what
a caller's loop around ``process_batch`` costs on the card.

Subcommands::

    python -m npswf_tpu_torch.tools.perf_probe floor    # no-op / two in flight / chained
    python -m npswf_tpu_torch.tools.perf_probe esweep   # E in {64,128,256,512}
    python -m npswf_tpu_torch.tools.perf_probe chain    # k in {1,2,4,8,16}

``floor`` times a no-op's launch and synchronised fetch (the round trip
every host sync pays), the pipeline with two batches in flight (the next
batch issued before the previous one's result is fetched) and chains of k
batches a call (the executor's stacked packets). Host clock around
synchronised work, on the card unless ``--cpu``. Each prints one
measurement a line, then one JSON line with every number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# The batch sizes esweep sweeps (each timed over at least four batches and
# one of the largest's events) and the chain lengths chain sweeps (each
# over --iters batches and at least two chains).
ESWEEP_EVENTS = (64, 128, 256, 512)
CHAIN_KS = (1, 2, 4, 8, 16)


def _setup(args):
    import torch
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
    from npswf_tpu_torch.runtime.executor import resolve_device
    from npswf_tpu_torch.utils.synthetic import make_events
    from npswf_tpu_torch.utils.timing import device_name, probe_config

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = probe_config()
    cal = synthetic_calibration(cfg, seed=1)
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float32)
    print(f"device: {device_name(dev)}", file=sys.stderr)

    def mk_batch(E, seed):
        truth = make_events(cfg, cal, E, occupancy=1.0, max_pulses=2,
                            pileup_prob=0.25, seed=seed)
        return batch_to_torch(truth.signal.astype(np.float32), truth.pres,
                              np.zeros(E), dev, torch.float32,
                              runnum=np.full(E, 3000))

    return cfg, calib, mk_batch, dev


def _pipelined(fn, batches, iters, force):
    """Seconds an iteration of ``fn`` over ``batches`` in turn, the next
    call issued before the previous result is fetched (two warm-ups)."""
    force(fn(batches[0]))
    force(fn(batches[-1]))
    t0 = time.perf_counter()
    prev = None
    for i in range(iters):
        o = fn(batches[i % len(batches)])
        if prev is not None:
            force(prev)
        prev = o
    force(prev)
    return (time.perf_counter() - t0) / iters


def _chi2(out):
    return out.chi2.cpu()


def cmd_floor(args, res):
    from npswf_tpu_torch.engine.pipeline import (make_pipeline_packed_chain,
                                                 process_batch)
    cfg, calib, mk_batch, dev = _setup(args)
    E = args.events
    batches = [mk_batch(E, 7), mk_batch(E, 9)]

    dt = _pipelined(lambda b: b.signal[0, 0, 0] + 1.0, batches, 16,
                    lambda o: o.item())
    print(f"noop launch + fetch round trip: {dt * 1e3:.4f} ms/iter")
    res["noop_ms"] = dt * 1e3

    dt = _pipelined(lambda b: process_batch(cfg, calib, b), batches,
                    args.iters, _chi2)
    print(f"two in flight, 1 batch a call: {dt * 1e3:.3f} ms/batch "
          f"({E * cfg.nblocks / dt:,.0f} blocks/s)")
    res["pipelined_ms_per_batch"] = dt * 1e3

    K = args.chain
    chain = make_pipeline_packed_chain(cfg, calib, 2 * E * cfg.nblocks)
    stacks = [[mk_batch(E, 20 + 2 * j + s) for j in range(K)] for s in (0, 1)]
    dt = _pipelined(chain, stacks, 4, lambda o: o.cpu()) / K
    print(f"chained {K} batches a call, 2 chains in flight: "
          f"{dt * 1e3:.3f} ms/batch ({E * cfg.nblocks / dt:,.0f} blocks/s)")
    res[f"chain{K}_ms_per_batch"] = dt * 1e3


def cmd_esweep(args, res):
    from npswf_tpu_torch.engine.pipeline import process_batch
    cfg, calib, mk_batch, dev = _setup(args)
    for E in ESWEEP_EVENTS:
        batches = [mk_batch(E, 7), mk_batch(E, 9)]
        dt = _pipelined(lambda b: process_batch(cfg, calib, b), batches,
                        max(4, ESWEEP_EVENTS[-1] // E), _chi2)
        print(f"E={E}: {dt * 1e3:.3f} ms/batch  {dt / E * 1e6:.1f} us/ev  "
              f"{E * cfg.nblocks / dt:,.0f} blocks/s")
        res[f"E{E}_ms_per_batch"] = dt * 1e3


def cmd_chain(args, res):
    from npswf_tpu_torch.engine.pipeline import make_pipeline_packed_chain
    cfg, calib, mk_batch, dev = _setup(args)
    E = args.events
    chain = make_pipeline_packed_chain(cfg, calib, 2 * E * cfg.nblocks)
    for K in CHAIN_KS:
        stacks = [[mk_batch(E, 30 + 2 * j + s) for j in range(K)]
                  for s in (0, 1)]
        dt = _pipelined(chain, stacks, max(2, args.iters // K),
                        lambda o: o.cpu()) / K
        print(f"k={K}: {dt * 1e3:.3f} ms/batch  "
              f"{E * cfg.nblocks / dt:,.0f} blocks/s")
        res[f"k{K}_ms_per_batch"] = dt * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("floor", cmd_floor), ("esweep", cmd_esweep),
                     ("chain", cmd_chain)):
        p = sub.add_parser(name)
        p.add_argument("--events", type=int, default=64)
        p.add_argument("--iters", type=int, default=8)
        p.add_argument("--chain", type=int, default=8)
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (default: the CUDA device)")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    res = {"probe": args.cmd}
    args.fn(args, res)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

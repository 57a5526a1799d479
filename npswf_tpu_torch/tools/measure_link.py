"""Measure the host<->card link and derive a dense batch's transfer floor.

Ported from npswf_tpu/tools/measure_link.py. Method: N timed transfers of
a buffer of at least 8 MB each way, between pinned host memory and the
card, reporting the MEDIAN; fresh host data every iteration so no layer
can cache the payload. From the medians it derives the per-batch transfer
floor of the dense 64-event batch as the executor moves it: the int16
signal [64, 1080, 110] and the small fields up (``_upload_batch``), the
dense writer packet down (``flatten_packet``). Given a device-only time a
batch (``--device-ms``), it also gives the fraction of that throughput a
run can reach when transfers do not overlap compute.

With ``--cpu`` the "transfers" are copies between two host buffers: a
check that the tool runs, not a link.

Output: one JSON object on stdout; progress on stderr.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Optional

import numpy as np

DENSE_EVENTS = 64


def dense_batch_bytes(E: int = DENSE_EVENTS):
    """(up, down) bytes of a dense E-event batch: the int16 signal and the
    fp64 small-field array up, the fp32 dense packet down."""
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.engine.pipeline import _packet_layout
    cfg = NPSConfig()
    B, T = cfg.nblocks, cfg.ntime
    up = E * B * T * 2 + E * (2 * B + 3) * 8
    down = 4 * sum(int(np.prod(shape)) for _, shape, _ in
                   _packet_layout(E, B, 2 * E * B))
    return up, down


def _timed_transfers(n: int, size_mb: float, rng: np.random.Generator,
                     device):
    """(h2d_s, d2h_s): n timed transfers each way between pinned host
    memory and ``device``."""
    import torch
    n_elem = int(size_mb * 1e6 / 4)
    pin = device.type == "cuda"
    host = torch.empty(n_elem, dtype=torch.float32, pin_memory=pin)
    back = torch.empty(n_elem, dtype=torch.float32, pin_memory=pin)
    dbuf = torch.empty(n_elem, dtype=torch.float32, device=device)

    def sync():
        if pin:
            torch.cuda.synchronize(device)
    h2d, d2h = [], []
    for i in range(n):
        host.numpy()[:] = rng.standard_normal(n_elem, dtype=np.float32)
        sync()
        t0 = time.perf_counter()
        dbuf.copy_(host, non_blocking=True)
        sync()
        h2d.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back.copy_(dbuf, non_blocking=True)
        sync()
        d2h.append(time.perf_counter() - t0)
        if not torch.equal(back[:16], host[:16]):
            raise AssertionError("transfer round trip corrupted data")
        print(f"  iter {i + 1}/{n}: H2D {size_mb / 1e3 / h2d[-1]:.3f} GB/s, "
              f"D2H {size_mb / 1e3 / d2h[-1]:.3f} GB/s", file=sys.stderr)
    return h2d, d2h


def measure_link(n: int = 9, size_mb: float = 64.0, seed: int = 0,
                 device_ms: Optional[float] = None, cpu: bool = False) -> dict:
    from npswf_tpu_torch.runtime.executor import resolve_device
    from npswf_tpu_torch.utils.timing import device_name
    dev = resolve_device("cpu" if cpu else "cuda")
    rng = np.random.default_rng(seed)
    print(f"device: {device_name(dev)}; {n} transfers of {size_mb:g} MB each "
          f"way", file=sys.stderr)
    _timed_transfers(1, size_mb, rng, dev)           # untimed warm-up
    h2d, d2h = _timed_transfers(n, size_mb, rng, dev)

    def stats(ts):
        bw = sorted(size_mb / 1e3 / t for t in ts)
        return {"median_GBps": statistics.median(bw), "min_GBps": bw[0],
                "max_GBps": bw[-1]}

    up, down = stats(h2d), stats(d2h)
    up_b, down_b = dense_batch_bytes()
    floor_ms = (up_b / (up["median_GBps"] * 1e9)
                + down_b / (down["median_GBps"] * 1e9)) * 1e3
    dense = {"events": DENSE_EVENTS, "up_mb": up_b / 1e6,
             "down_mb": down_b / 1e6, "transfer_floor_ms": floor_ms,
             "device_only_ms": device_ms, "serial_ceiling_frac": None}
    if device_ms:
        dense["serial_ceiling_frac"] = device_ms / (device_ms + floor_ms)
    return {"device": device_name(dev), "transfer_mb": size_mb, "n": n,
            "h2d": up, "d2h": down, "dense_batch": dense}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=7,
                    help="timed transfers a direction (median reported)")
    ap.add_argument("--size-mb", type=float, default=16.0,
                    help="transfer size; keep it >= 8 MB so the rate is the "
                         "sustained one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-ms", type=float, default=None,
                    help="device-only ms a dense batch, for the ceiling")
    ap.add_argument("--json", default=None, help="also write the report here")
    ap.add_argument("--cpu", action="store_true",
                    help="host-to-host copies (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.size_mb < 8.0:
        print("WARNING: transfers under 8 MB overstate the sustained rate",
              file=sys.stderr)
    rep = measure_link(args.n, args.size_mb, args.seed, args.device_ms,
                       args.cpu)
    line = json.dumps(rep)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

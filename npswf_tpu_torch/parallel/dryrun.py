"""Self-checking dry run of the mesh: one batch on one device, then over
meshes of ``n`` ranks, every output field compared.

Counterpart of the JAX package's multi-chip dry run: the same batch runs
unsharded first, then on a pure-data mesh (n x 1), on the widest data x
block split that the 36 calorimeter rows admit, and on an intermediate
split where there is one. The batch has pileup (the mid fit bucket) and
adversarial events (retries and real failures), so a divergence in the
ladder or the bucket routing has somewhere to show. Every kernel works per
lane and the event totals are summed in one device's order, so the port
requires every field equal, value for value, except that on a card the
event totals may differ by their sum's rounding (the card's row reduction
picks its order by the number of events a shard holds; the dense bench
batch's shards of 32 events keep one device's order); on the card each
rank must also
have launched its kernels and called no plain version.

    python -m npswf_tpu_torch.parallel.dryrun --ranks 4 --cpu
    python -m npswf_tpu_torch.parallel.dryrun --ranks 4 --share-card

(``--cpu``: gloo ranks on the CPU; ``--share-card``: gloo ranks sharing
``cuda:0``; neither: one card a rank on NCCL.) Prints one JSON line and
exits non-zero when a mesh disagrees.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import (EventBatch, PipelineOutput,
                                             process_batch)
from npswf_tpu_torch.parallel.mesh import make_mesh, sharded_process_batch
from npswf_tpu_torch.runtime.executor import torch_dtype
from npswf_tpu_torch.utils.synthetic import adversarial_variants, make_events

# kernels of the default route: each rank launches them on the card
RANK_KERNELS = (kernels.MATCHED_FILTER, kernels.SEARCH_OPERANDS,
                kernels.LM_SOLVE)


def mesh_shapes(cfg: NPSConfig, n: int) -> List[Tuple[int, int]]:
    """(n, 1), the widest (n / b, b) with b in 2, 3, 4, 6 dividing n and
    the rows, and an intermediate split below it where there is one."""
    n_block = 1
    for cand in (2, 3, 4, 6):
        if n % cand == 0 and cfg.nlin % cand == 0:
            n_block = cand
    shapes = [(n, 1)]
    if n_block > 1:
        shapes.append((n // n_block, n_block))
    for mid in (2, 3):
        if 1 < mid < n_block and n % mid == 0 and cfg.nlin % mid == 0:
            shapes.append((n // mid, mid))
            break
    return shapes


# PipelineOutput's event totals: each sums every block of an event
_TOTALS = ("enertot", "integtot")


def unequal_fields(a: PipelineOutput, b: PipelineOutput,
                   totals_exact: bool = True) -> List[str]:
    """Fields of two host outputs that differ anywhere (NaN equals NaN).
    With ``totals_exact`` off, the event totals may differ by the rounding
    of a sum of B blocks in another order (2 B eps of the largest total):
    a card's row reduction picks its order by the number of events a shard
    holds."""
    bad = []
    for name, x, y in zip(PipelineOutput._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        if name in _TOTALS and not totals_exact and x.shape == y.shape:
            B = np.asarray(a.wfnpulse).shape[-1]
            tol = 2 * B * np.finfo(y.dtype).eps * np.abs(y).max(initial=0.0)
            if not np.all(np.abs(x.astype(np.float64) - y) <= tol):
                bad.append(name)
        elif not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            bad.append(name)
    return bad


def totals_diff(a: PipelineOutput, b: PipelineOutput) -> float:
    """The largest difference between the two outputs' event totals."""
    return max(float(np.abs(np.asarray(getattr(a, k), np.float64)
                            - np.asarray(getattr(b, k))).max(initial=0.0))
               for k in _TOTALS)


def rank_kernel_faults(counts) -> List[str]:
    """Ranks that missed a kernel of the default route or called a plain
    version, one line each."""
    bad = []
    for r, c in enumerate(counts):
        missing = [k for k in RANK_KERNELS if not c["launches"].get(k)]
        if missing or any(c["plain_calls"].values()):
            bad.append(f"rank {r}: missing {missing}, plain {c['plain_calls']}")
    return bad


def dryrun_batch(cfg: NPSConfig, cal, E: int, seed: int = 5) -> EventBatch:
    """The dry run's batch of E events (host tensors in the compute dtype):
    pileup, so the mid fit bucket engages, and in its last quarter the
    solver audit's wrong-shape and correlated-noise ensembles, so retries
    and real failures engage."""
    truth = make_events(cfg, cal, E, occupancy=0.25, max_pulses=6,
                        pileup_prob=0.5, seed=seed)
    signal = truth.signal.copy()
    adv = adversarial_variants(cfg, cal, truth, seed=seed + 17)
    k = max(2, E // 4)
    half = k // 2
    signal[-k:-k + half] = adv["wrong_shape"][-k:-k + half]
    signal[-k + half:] = adv["correlated_noise"][-k + half:]
    corr = np.random.default_rng(seed).uniform(-2, 2, E)
    return batch_to_torch(signal, truth.pres, corr, "cpu", torch_dtype(cfg))


def dryrun(cfg: NPSConfig, cal, batch: EventBatch,
           meshes: Sequence[Tuple[str, int, int]], devices: Sequence[str],
           engaged: bool = False) -> dict:
    """``batch`` (host tensors) through ``process_batch`` on ``devices[0]``,
    then over each mesh ``(backend, n_data, n_block)`` of the first
    ``n_data * n_block`` of ``devices``, the meshes launched together.
    Raises AssertionError when a mesh's output differs from one device's
    in any field (on a card, the event totals within their sum's rounding,
    ``unequal_fields``), or, on a card, a rank missed a kernel of the
    default route or called a plain version; with ``engaged``, also when
    the batch has no failed fit or no lane in the mid bucket."""
    dev = torch.device(devices[0])
    ref = process_batch(cfg, calib_to_torch(cal.device_arrays(cfg), dev,
                                            torch_dtype(cfg)),
                        EventBatch(*(None if t is None else t.to(dev)
                                     for t in batch)))
    ref = PipelineOutput(*(t.cpu().numpy() for t in ref))
    npulse = ref.wfnpulse
    report = {"events": int(npulse.shape[0]), "pulses": int(npulse.sum()),
              "mid_bucket_lanes": int(((npulse > cfg.fit_small_pulses)
                                       & (npulse <= cfg.fit_mid_pulses)).sum()),
              "fit_success": int(ref.n_fit_success),
              "fit_failures": int(ref.n_fit_failure), "meshes": {}}
    if engaged:
        assert report["fit_failures"] > 0 and report["mid_bucket_lanes"] > 0, \
            f"the batch must engage the retries and the mid bucket: {report}"

    def one(backend, n_data, n_block):
        mesh = make_mesh(cfg, n_data, n_block,
                         devices=devices[:n_data * n_block], backend=backend)
        t0 = time.perf_counter()
        res = sharded_process_batch(mesh, cfg, cal.device_arrays(cfg), batch)
        return res, time.perf_counter() - t0
    # each launch's time goes mostly to starting its ranks
    with ThreadPoolExecutor(max_workers=len(meshes)) as pool:
        runs = [pool.submit(one, *m) for m in meshes]
    for (backend, n_data, n_block), run in zip(meshes, runs):
        (out, counts), wall = run.result()
        bad = unequal_fields(out, ref, totals_exact=dev.type != "cuda")
        if dev.type == "cuda":
            bad += rank_kernel_faults(counts)
        report["meshes"][f"{backend} {n_data}x{n_block}"] = {
            "seconds_with_start": wall, "unequal": bad,
            "totals_max_diff": totals_diff(out, ref),
            "launches": [c["launches"] for c in counts]}
    bad = {k: m["unequal"] for k, m in report["meshes"].items() if m["unequal"]}
    assert not bad, f"meshes differ from one device: {bad}"
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--events", type=int, default=0,
                    help="events of the batch (default max(2 ranks, 4))")
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--cpu", action="store_true",
                       help="gloo ranks on the CPU")
    where.add_argument("--share-card", action="store_true",
                       help="gloo ranks sharing cuda:0")
    args = ap.parse_args(argv)
    if args.cpu:
        devices, backend = ["cpu"] * args.ranks, "gloo"
    elif args.share_card:
        devices, backend = ["cuda:0"] * args.ranks, "gloo"
    else:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        backend = "nccl"
    if len(devices) < args.ranks:
        print(f"dryrun: need {args.ranks} devices, have {len(devices)}",
              file=sys.stderr)
        return 2
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    batch = dryrun_batch(cfg, cal, args.events or max(2 * args.ranks, 4))
    meshes = [(backend, nd, nb) for nd, nb in mesh_shapes(cfg, args.ranks)]
    try:
        rep = dryrun(cfg, cal, batch, meshes, devices, engaged=True)
    except AssertionError as e:
        print(f"dryrun FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())

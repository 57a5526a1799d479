#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``npswf_tpu_torch/csrc`` with nvcc
(one nvcc per source, all started together), holds each of the seven
kernels against its plain PyTorch version on the card at the main path's
shapes (K3 also as the fit's whole retry ladder in one launch, against
the host ladder over its plain version, and timed against stage 1 and the
rungs launched one by one), and drives ``process_batch`` on the dense 64-event batch of the
full 1080-block calorimeter along four routes: the default path (K1, K2,
K3), the generic LM loop with the in-kernel top-P search (K1, K4, K5) and
its two system variants (K5 + K7, and K6). Each route's launch counts are
read from its own run, its result is checked, and it is timed against the
plain path. ``[graph]`` holds ``process_batch`` on the graph route (two
CUDA graph replays around one read of the bucket sizes) to its eager body
on dense, pileup, fp64 and sparse-readout batches (search_capacity 8,640)
and capped buckets (fit_capacity 8,640), three of each in turns and after
a calibration swap: every field bit-equal, each replay's launches and
counters the eager call's, its kernels under torch.profiler the eager
call's, K2 and K3 among them. The ``[buckets]`` phase runs a pileup-heavy batch under bucket
bounds that route lanes to fit widths 1, 2, 4, 5, 10 and 12, on the
default route (K3) and on ``use_fused_system`` (K6, every LM budget cut
to 4 iterations), each bucket's decisions against the plain path. Then the ``[segment]`` phase drives the production entry
point, ``runtime.executor.run_segment``, from raw segments built in memory
to WF files: 2,048 events read out sparsely (occupancy 0.03: the slab
packet, the present-lane upload), once plain and once in chains of 4, and
512 dense events (the dense packet), with the launch counts of each run
held to those of its batches run alone (plus the batches its dense
fallback reran), the file's checks, the packet path against the dense path
on the first two batches, the stage medians; then the CLI (synth, run, validate) in a
subprocess. ``[search-wide]`` holds K2 and K4 at TSpectrum sigmas and
Markov windows past the default frame's margin (sigma 2.6 to 40, windows
17 to 487) and at and one past the widest a block of 8 lanes takes
(``ops.search_kernel.search_layout``) to their plain versions on the
dense batch's lanes, runs the dense batch at sigma = 3, threshold 0.05
(fp32) and at sigma 20 and 27 with window 487 (fp64) on the default and
slice routes against the plain path, and reproduces the SearchHighRes
fixtures through K2 and K4.
The ``[models]`` phase fits the dense batch with the gaussian
and biexp families (K1 and K2, then the generic loop in plain PyTorch),
against the plain path, timed, and a batch of true gaussian pulses against
its truth; ``[k3-wide]`` holds K3 at 13-15 pulses (compiled widths) and at
16, 24, 48 and the widest a block's shared memory holds (the wide unit, P
at run time) to its plain version, times the wide unit, refuses one more,
and runs a pileup batch whose widest bucket is 24, then 15, 110, K3's
limit (fp64) and 64 (``use_fused_system``) against it; ``[tools]`` runs the CLI's
parity, extract-templates (then run with the extracted calibration),
solver-audit and cpu-baseline in subprocesses, and the audit's fit in
process with its launches counted. ``[mesh]`` runs the dense batch over a
world of one rank on NCCL and over gloo ranks sharing the card (2x1, 1x2,
2x2), every field against one device and K1-K3 launched on every rank,
then the dense segment through ``run_segment`` on a 2x2 mesh, its WF file
against the single-device one; ``[probes]`` runs measure-link, perf-probe
floor, e2e-bench and glue-profile through the CLI. It prints one JSON line
of kernel records (times, launches, bounds), one of the graph route, one
each of the segment runs,
the buckets, the model families, K3's wide widths, the wide search
settings, the tools, the mesh and
the probes, the card's name and power limit, and a last JSON line
``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero. It imports no jax. Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.

``python3 chip_smoke.py --time-systems ROOT`` only times K2 and K4 at the
default search settings, K6 and K7 (the
wrapper and the kernel alone) and K3's wide unit at P = 24, and ``--time-route ROOT`` only the default
route's batch, with the package of the checkout at ROOT, to compare two
checkouts on one card in turns.
"""
from __future__ import annotations

import collections
import json
import logging
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's dense batch: E events x 1080 blocks x 110 samples, fp32
E_BENCH = 64
FAIL_RATE_MAX = 0.02
# the [segment] phase: (events, occupancy, pileup, seed, sparse readout);
# segments are built in chunks of SEG_CHUNK events and run in batches of
# SEG_BATCH, SEG_CHAIN batches a call for the chained run
SEGMENTS = {"sparse": (2048, 0.03, 0.3, 101, True),
            "dense": (512, 1.0, 0.25, 7, False)}
SEG_CHUNK = 64
SEG_BATCH = 64
SEG_CHAIN = 4
CLI_EVENTS = 32
# [models]: the families and their shape constants (tests/test_models.py)
MODEL_FAMILIES = {"gaussian": (("width", 3.5),),
                  "biexp": (("tau_r", 1.8), ("tau_d", 9.0))}
# [k3-wide]: (P, most pulses a lane) of the kernel checks ("limit": the
# widest P a lane of the type fits, lm_max_pulses), the fp32 widths timed,
# their lane count, the iterations a call at the limit is cut to (the plain
# version's substitutions take M^2 launches an iteration), the bucket
# bounds that send 3-4 pulse lanes to width 24 (K3's wide unit; its run is
# held to the plain path), and the widths the path runs at against that
# run: 15 (the widest compiled width) and 110 in fp32 (the widest
# process_batch takes at T = 110: the search returns at most T slots, and
# both packages' pipelines raise past it) and K3's limit in fp64 on the
# default route, 64 under use_fused_system (K6 one lane a block)
WIDE_WIDTHS = ((13, 13), (14, 7), (15, 15), (16, 16), (24, 8), (48, 8),
               ("limit", 8))
WIDE_TIMED = (16, 24, 48, "limit")
WIDE_LANES = 4096
WIDE_LIMIT_ITERS = 4
WIDE_BUCKETS_24 = dict(fit_small_pulses=2, fit_mid_pulses=2, maxwfpulses=24,
                       pallas_lm_max_pulses=24)
WIDE_PATHS = (("default", "float32", 15), ("default", "float32", 110),
              ("default", "float64", "limit"), ("fused_system", "float32", 64))
# the generic loop's plain Cholesky takes ~M^2 launches an iteration (0.8 s
# at M = 129): the fused_system runs (its path runs, both widths alike, and
# its [buckets] runs) cut every LM budget to 4 iterations (and no stage-3
# rungs)
WIDE_PATH_BUDGETS = {"fused_system": dict(
    lm_max_iter_stage1=4, lm_stage1_wide=4, lm_max_iter_stage2=4,
    lm_stage2_wide=4, lm_stage3=False)}
# [search-wide]: (spec_sigma, spec_aver_window) past the default frame's
# 16-row margin (Gold reaches 17, 20, 26, 67; windows 17, 24, 64) and past
# what the card once took (Gold reaches 130, 181, 268: taps past the 128
# of the launch's parameters; sigma 27's widest window), held on the dense
# batch's lanes beside the widest settings a block of 8 lanes takes and
# one past each (in fp32 the widest sigma, ~78.6, also puts the extension
# fit's 2 sigma bins past the 110 that exist); the settings and types the
# dense batch runs at on the default and slice routes, against the plain
# path at the same setting
SEARCH_WIDE = ((2.6, 3), (3.0, 3), (4.0, 3), (10.0, 3), (2.0, 17),
               (2.0, 24), (2.0, 64), (19.5, 3), (27.0, 487), (40.0, 3))
# the settings timed at fp32: K2 and K4 at the first seven, K2 alone past them
# (K4 differs from K2 there by its P rounds of selection only)
SEARCH_TIMED_BOTH = SEARCH_WIDE[:7]
SEARCH_WIDE_BATCH = dict(spec_sigma=3.0, specthres=0.05)
REACH_LANES = 8640   # 8 events: the lanes the reach's edges are held on
SEARCH_WIDE_BATCHES = ((SEARCH_WIDE_BATCH, "float32"),
                       (dict(spec_sigma=20.0), "float64"),
                       (dict(spec_sigma=27.0, spec_aver_window=487), "float64"))
# [mesh]: the mesh shapes of gloo ranks sharing cuda:0 (a world of one rank
# on NCCL runs first), and the shape of the segment run
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
MESH_SEGMENT_SHAPE = (2, 2)
# [tools]: events of the extraction segment and of each audit ensemble
EXTRACT_EVENTS = 16
AUDIT_EVENTS = 1
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside the
# tensor cores in operations/s
MEM_RATE = 3.35e12
FP32_RATE = 67e12
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "matched_filter": ("npswf_tpu_torch/csrc/matched_filter.cu",
                       "npswf_tpu/ops/pallas_kernels.py:38"),
    "search_operands": ("npswf_tpu_torch/csrc/search.cu",
                        "npswf_tpu/ops/pallas_search.py:68"),
    "search_topk": ("npswf_tpu_torch/csrc/search.cu",
                    "npswf_tpu/ops/pallas_search.py:277"),
    "lm_solve": ("npswf_tpu_torch/csrc/lm.cuh",
                 "npswf_tpu/fit/pallas_lm.py:122"),
    "fused_eval": ("npswf_tpu_torch/csrc/eval.cu",
                   "npswf_tpu/fit/pallas_eval.py:64"),
    "fused_neq": ("npswf_tpu_torch/csrc/eval.cu",
                  "npswf_tpu/fit/pallas_eval.py:314"),
    "fused_system": ("npswf_tpu_torch/csrc/eval.cu",
                     "npswf_tpu/fit/pallas_eval.py:171"),
}
# the routes of process_batch: the configuration flags of each, and the
# kernels that must launch and those that must not
SLICE = dict(use_pallas_lm=False, pallas_search_select=True)
ROUTE_FLAGS = {"default": {}, "slice": SLICE,
               "fused_neq": dict(SLICE, use_fused_neq=True),
               "fused_system": dict(SLICE, use_fused_system=True)}
ROUTES = {
    "default": (("matched_filter", "search_operands", "lm_solve"),
                ("search_topk", "fused_eval", "fused_neq", "fused_system")),
    "slice": (("matched_filter", "search_topk", "fused_eval"),
              ("search_operands", "lm_solve", "fused_neq", "fused_system")),
    "fused_neq": (("fused_eval", "fused_neq"),
                  ("search_operands", "lm_solve", "fused_system")),
    "fused_system": (("fused_system",),
                     ("search_operands", "lm_solve", "fused_eval",
                      "fused_neq")),
}
# the route whose run gives each kernel's launch count
LAUNCHES_FROM = {"matched_filter": "default", "search_operands": "default",
                 "lm_solve": "default", "search_topk": "slice",
                 "fused_eval": "slice", "fused_neq": "fused_neq",
                 "fused_system": "fused_system"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T_START = time.perf_counter()


def say(phase, msg):
    print(f"[{phase}] {msg} [t {time.perf_counter() - T_START:.1f} s]",
          flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------
# bounds: the larger of bytes / memory rate and operations / fp32 rate
# ---------------------------------------------------------------------
def nbytes(*ts):
    """Bytes of the tensors, each read or written once."""
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nb, nops):
    t_mem, t_ops = nb / MEM_RATE * 1e3, nops / FP32_RATE * 1e3
    return {"bound_ms": max(t_mem, t_ops),
            "bound_by": "bytes" if t_mem >= t_ops else "operations",
            "bytes": int(nb), "operations": int(nops)}


def ops_search(cfg, N, T, P=0):
    """Arithmetic operations of the search per lane and extended-frame bin
    (each add, multiply, divide, compare or transcendental counted once):
    Markov 12 a window step + 4, weights 6, Gold response 2 a tap and 2 a
    tap + 4 per iteration, centroid 15; plus P x T compares to select."""
    from npswf_tpu_torch.ops.peak_search import search_geometry
    _, size_ext, _, _, lh_gold, _, _ = search_geometry(cfg, T)
    per_bin = (12 * cfg.spec_aver_window + 4 + 6 + 2 * lh_gold
               + cfg.spec_decon_iterations * (2 * (2 * lh_gold - 1) + 4) + 15)
    return N * size_ext * per_bin + N * P * T


def ops_system(K, P):
    """One spline system evaluation of one lane: 25 operations a pulse and
    bin (coefficients, two Horner forms, gate, model, columns), the packed
    normal equations (2 an entry), the transform."""
    M = 1 + 2 * P
    MT = M * (M + 1) // 2
    return K * (25 * P + 2 * MT + 2 * M + 5) + 5 * M + 5 * P


# ---------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------
def bench_batch(torch, cfg, cal, dev):
    """bench.py's batch: seed 7, occupancy 1.0, max 2 pulses, pileup 0.25,
    corr_time_HMS from default_rng(11)."""
    from npswf_tpu_torch.core.params import batch_to_torch
    from npswf_tpu_torch.utils.synthetic import make_events
    truth = make_events(cfg, cal, E_BENCH, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    corr = np.random.default_rng(11).uniform(-2, 2, E_BENCH).astype(np.float32)
    batch = batch_to_torch(truth.signal.astype(np.float32), truth.pres, corr,
                           dev, torch.float32)
    return truth, batch


def lm_inputs(torch, cfg, cal, n, max_pulses, P, seed, dtype, dev,
              noise=0.8, seed_jitter=1.5):
    """One LM stage's inputs for n lanes with known truth, built as
    tests/test_fit.py::_build_inputs does (vectorized): 1..max_pulses
    spline pulses, seeds jittered inside the +-4-bin bounds."""
    from npswf_tpu_torch.fit.errors import error_model
    from npswf_tpu_torch.fit.eval_kernel import pad_coeffs
    from npswf_tpu_torch.fit.lm import FitInputs, _prepare
    from npswf_tpu_torch.ops.spline import spline_eval
    rng = np.random.default_rng(seed)
    cfg = cfg.replace(maxwfpulses=max(cfg.maxwfpulses, P))  # P columns
    T, Pmax = cfg.ntime, cfg.maxwfpulses
    blocks = rng.integers(0, cfg.nblocks, n)
    x = np.arange(T, dtype=np.float64)
    sig = rng.uniform(-5, 5, n)[:, None] + noise * rng.standard_normal((n, T))
    npul = rng.integers(1, max_pulses + 1, n)
    pmask = np.arange(Pmax)[None, :] < npul[:, None]
    t_true = rng.uniform(-3, 3, (n, Pmax))
    t_true[:, 1:] += rng.uniform(-25, 25, (n, Pmax - 1))
    a_true = rng.uniform(40, 180, (n, Pmax))
    coeffs = torch.as_tensor(cal.spline_coeffs[blocks])
    x0 = torch.as_tensor(cal.spline_x0[blocks])
    for p in range(max_pulses):
        arg = x[None, :] - t_true[:, p:p + 1]
        val = spline_eval(cfg, coeffs, x0, torch.as_tensor(arg)).numpy()
        gate = (arg > cfg.spline_gate_lo) & (arg < T - 1) & pmask[:, p:p + 1]
        sig += np.where(gate, a_true[:, p:p + 1] * val, 0.0)
    t_seed = np.where(pmask, t_true + seed_jitter * rng.uniform(-1, 1, (n, Pmax)), 0.0)
    a_seed = np.where(pmask, a_true * rng.uniform(0.6, 1.6, (n, Pmax)), 0.0)
    lo_b, hi_b = cfg.fit_lo_bin, cfg.fit_hi_bin

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    sig_t = t(sig)
    inp = FitInputs(y=sig_t[:, lo_b:hi_b], sigma=error_model(cfg, sig_t)[:, lo_b:hi_b],
                    coeffs=t(cal.spline_coeffs[blocks]), x0=t(cal.spline_x0[blocks]),
                    t_seed=t(t_seed[:, :P]), a_seed=t(a_seed[:, :P]),
                    ped_seed=t(sig[:, :cfg.ped_nsamples].mean(axis=1)),
                    pulse_mask=torch.as_tensor(pmask[:, :P], device=dev),
                    active=torch.ones(n, dtype=torch.bool, device=dev))
    lo, hi, p_seed, pm, u0, s1_budget, _ = _prepare(cfg, inp)
    s1_cap = max(cfg.lm_max_iter_stage1, cfg.lm_stage1_wide)
    return (pad_coeffs(inp.coeffs), inp.x0, inp.y, 1.0 / inp.sigma, u0, lo,
            hi, p_seed, pm, inp.active, s1_cap, cfg.lm_lambda_init, s1_budget)


def lm_retry_inputs(torch, cfg, cal, n, max_pulses, P, seed, dtype, dev):
    """A retry-shaped LM call: n lanes restarted from their seeds at the
    stage-2 cap with lambda0 x 10 and the stage-2 budgets (60, or 120 for
    lanes of more than lm_wide_pulses pulses); lane i is inactive when
    i % 5 == 2 and has budget 0 when i % 7 == 3."""
    args = list(lm_inputs(torch, cfg, cal, n, max_pulses, P, seed, dtype, dev))
    idx = torch.arange(n, device=dev)
    wide = args[8][:, 2::2].sum(dim=1) > cfg.lm_wide_pulses
    budget = torch.where(wide, cfg.lm_stage2_wide, cfg.lm_max_iter_stage2)
    args[9] = idx % 5 != 2
    args[10] = max(cfg.lm_max_iter_stage2, cfg.lm_stage2_wide)
    args[11] = cfg.lm_lambda_init * 10.0
    args[12] = torch.where(idx % 7 == 3, 0, budget).to(torch.int32)
    return tuple(args)


def lm_equal(torch, k, p, fields=(0, 1, 2, 3, 5)):
    """Lanes on which two LM results agree in the outputs ``fields`` (of a
    stage: u, chi2, conv, n_iter and lambda), each value equal (a NaN
    matching a NaN)."""
    def same(a, b):
        eq = a == b
        if a.is_floating_point():
            eq = eq | (torch.isnan(a) & torch.isnan(b))
        return eq if eq.dim() == 1 else eq.all(dim=1)
    lanes = same(k[fields[0]], p[fields[0]])
    for i in fields[1:]:
        lanes = lanes & same(k[i], p[i])
    return int(lanes.sum())


def lm_bound(torch, cfg, args, out):
    """K3's bound on one call: its tensors read and written once, and the
    system evaluations and damped solves that its lanes' n_iter need."""
    M = args[4].shape[1]
    P = (M - 1) // 2
    K = args[2].shape[1]
    it = out[3][args[9]].to(torch.float64)
    nops = float(((it + 1) * ops_system(K, P)
                  + it * (M ** 3 + 4 * M * M + 10 * M)).sum())
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    return bound(nbytes(*ins, *out), nops)


def mf_lanes(torch, cal, signal, dev):
    """K1's inputs for the lanes of ``signal`` [E, B, T] (numpy, fp64): the
    raw signal, its minimum, the block's reversed kernel and mfint."""
    E, B, T = signal.shape
    sig = torch.as_tensor(signal.reshape(E * B, T), device=dev)
    return (sig, sig.amin(dim=1),
            torch.as_tensor(np.tile(cal.mfkern_rev, (E, 1)), device=dev),
            torch.as_tensor(np.tile(cal.mfint, E), device=dev))


def n_unequal(torch, a, b):
    """Values of two tensors that differ (a NaN matching a NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def max_abs_diff(torch, pairs):
    """Largest |a - b| over the pairs, NaN and inf differences left out."""
    return max(float(torch.nan_to_num((a - b).abs(), nan=0.0, posinf=0.0).max())
               for a, b in pairs)


# ---------------------------------------------------------------------
# phases: each kernel against its plain version
# ---------------------------------------------------------------------
def check_matched_filter(torch, cfg, lanes, records):
    import torch.nn.functional as F
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.ops.mf_kernel import matched_filter_kernel
    for dt in (torch.float64, torch.float32):
        args = [a.to(dt) for a in lanes]
        k = matched_filter_kernel(cfg, *args)
        p = matched_filter(cfg, *args)
        torch.cuda.synchronize()
        ndiff = n_unequal(torch, k, p)
        err = max_abs_diff(torch, [(k, p)])
        say("K1", f"{dt}: {ndiff} of {k.numel()} values differ (bitwise), "
                  f"max|d| {err:.3e}")
        check(ndiff == 0, f"matched filter not bit-equal at {dt}")
    args = [a.to(torch.float32) for a in lanes]
    N, T = args[0].shape
    # yardstick: the correlation alone as one depthwise convolution (full
    # fp32, the port never calls it; another rounding than the kernel's)
    delta = (args[0] - args[1][:, None])[None]
    weight = args[2][:, None, :].contiguous()
    records["matched_filter"].update(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: matched_filter_kernel(cfg, *args), 20),
        plain_ms=cuda_ms(torch, lambda: matched_filter(cfg, *args), 20),
        library_ms=cuda_ms(torch, lambda: F.conv1d(delta, weight, groups=N), 20),
        **bound(nbytes(*args, k.to(torch.float32)),
                N * T * (4 * cfg.mfwidth + 2)))


def check_search(torch, cfg, src, aux, records):
    """K2 against the plain search_operands: all four operands bit-equal on
    every bin at both types. src: the fp32-quantized filter output; aux: the
    raw signal."""
    from npswf_tpu_torch.ops.peak_search import search_operands
    from npswf_tpu_torch.ops.search_kernel import search_operands_kernel
    N, T = src.shape
    for dt in (torch.float64, torch.float32):
        s, a = src.to(dt), aux.to(dt)
        p = search_operands(cfg, s, a, -1)
        n_acc = int(torch.isfinite(p[0]).sum())
        check(n_acc > N, "too few accepted peaks for a meaningful check")
        k = search_operands_kernel(cfg, s, a, -1)
        torch.cuda.synchronize()
        ndiff = [n_unequal(torch, x, y) for x, y in zip(k, p)]
        say("K2", f"{dt}: {n_acc} accepted bins of {N * T}; values differing "
                  f"bitwise (negkey, cent, pos_y, aux) {ndiff}")
        check(sum(ndiff) == 0, f"search_operands not bit-equal at {dt}")
        err = max_abs_diff(torch, zip(k, p))
        del k, p
    s, a = src.to(torch.float32), aux.to(torch.float32)
    records["search_operands"].update(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: search_operands_kernel(cfg, s, a, -1), 10),
        plain_ms=cuda_ms(torch, lambda: search_operands(cfg, s, a, -1), 3),
        library_ms=None,
        **bound(nbytes(s, a) + 4 * nbytes(s), ops_search(cfg, N, T)))


def check_search_topk(torch, cfg, src, aux, records):
    """K4 against the plain search_topk: every slot's negkey, cent, pos_y
    and aux bit-equal at both types."""
    from npswf_tpu_torch.ops.peak_search import search_topk
    from npswf_tpu_torch.ops.search_kernel import search_topk_kernel
    N, T = src.shape
    P = cfg.maxwfpulses
    for dt in (torch.float64, torch.float32):
        s, a = src.to(dt), aux.to(dt)
        p = search_topk(cfg, s, a, -1, P)
        n_valid = int((p[0] < float("inf")).sum())
        check(n_valid > N, "too few valid slots for a meaningful check")
        k = search_topk_kernel(cfg, s, a, -1, P)
        torch.cuda.synchronize()
        ndiff = [n_unequal(torch, x, y) for x, y in zip(k, p)]
        say("K4", f"{dt}: {n_valid} valid slots of {N * P}; values differing "
                  f"bitwise on all slots (negkey, cent, pos_y, aux) {ndiff}")
        check(sum(ndiff) == 0, f"search_topk not bit-equal at {dt}")
        err = max_abs_diff(torch, zip(k[1:], p[1:]))
    s, a = src.to(torch.float32), aux.to(torch.float32)
    records["search_topk"].update(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: search_topk_kernel(cfg, s, a, -1, P), 10),
        plain_ms=cuda_ms(torch, lambda: search_topk(cfg, s, a, -1, P), 3),
        library_ms=None,
        **bound(nbytes(s, a) + 4 * N * P * 4, ops_search(cfg, N, T, P)))


def check_lm(torch, cfg, cal, dev, records):
    from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel, lm_solve_plain
    n = cal.nblocks * E_BENCH
    for P, max_pulses in ((2, 2), (4, 4), (12, 6)):
        for dt in (torch.float64, torch.float32):
            args = lm_inputs(torch, cfg, cal, n, max_pulses, P, 21 + P, dt, dev)
            k = lm_solve_kernel(cfg, *args)
            p = lm_solve_plain(cfg, *args)
            torch.cuda.synchronize()
            u_k, chi2_k, conv_k, it_k, _, lam_k = k
            u_p, chi2_p, conv_p, it_p, _, lam_p = p
            conv_flip = int((conv_k != conv_p).sum())
            traj_flip = int(((it_k != it_p) | (conv_k != conv_p)).sum())
            same = (it_k == it_p) & (conv_k == conv_p)
            du = float((u_k - u_p).abs()[same].max())
            dchi = float(((chi2_k - chi2_p).abs()
                          / chi2_p.abs().clamp(min=1.0))[same].max())
            n_conv = int(conv_p.sum())
            n_bit = int((u_k == u_p).all(dim=1).sum())
            n_eq = lm_equal(torch, k, p)
            say("K3", f"P={P} {dt}: {n} lanes, {n_conv} converged; conv "
                      f"flips {conv_flip}, n_iter flips {traj_flip}; u "
                      f"bit-equal on {n_bit} lanes; u, chi2, conv, n_iter "
                      f"and lambda equal on {n_eq}; on same-trajectory lanes "
                      f"max|du| {du:.3e}, max rel dchi2 {dchi:.3e}")
            check(n_conv > n // 2, "too few converged lanes")
            check(n_eq == n, f"K3 not bit-equal to its plain version at "
                             f"P={P} {dt}")
            if dt == torch.float64:
                check(conv_flip == 0 and traj_flip == 0,
                      "fp64 conv/n_iter differ")
                check(bool(torch.allclose(u_k, u_p, rtol=1e-8, atol=1e-8)),
                      "fp64 u differs beyond 1e-8")
                check(bool(torch.allclose(chi2_k, chi2_p, rtol=1e-9, atol=1e-9)),
                      "fp64 chi2 differs beyond 1e-9")
                check(bool(torch.allclose(lam_k, lam_p, rtol=1e-9)),
                      "fp64 lambda differs")
            else:
                # fp32: both sum in one order; the band is the flip band of
                # tests/test_routing.py: convergence decisions may flip on
                # at most max(4, 2%) of the converged lanes, and lanes on the
                # same trajectory agree to fp32 rounding
                check(conv_flip <= max(4, n_conv // 50), "fp32 conv flips")
                check(du <= 1e-3, "fp32 same-trajectory u differs")
                if P == 2:
                    records["lm_solve"]["max_abs_err"] = du
                    records["lm_solve"].update(
                        ms=cuda_ms(torch, lambda: lm_solve_kernel(cfg, *args), 3),
                        plain_ms=cuda_ms(torch, lambda: lm_solve_plain(cfg, *args), 1),
                        library_ms=None, **lm_bound(torch, cfg, args, k))
            del args, k, p


def check_lm_retry(torch, cfg, cal, dev):
    """K3 on retry-shaped calls of 1, 37 and 301 lanes (a partial last
    block, inactive lanes, budgets of 0, 60 and 120): u, chi2, conv, n_iter
    and lambda equal to the plain version on every lane."""
    from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel, lm_solve_plain
    for P, max_pulses in ((2, 2), (12, 6)):
        for dt in (torch.float64, torch.float32):
            for n in (1, 37, 301):
                args = lm_retry_inputs(torch, cfg, cal, n, max_pulses, P,
                                       71 + n + P, dt, dev)
                k = lm_solve_kernel(cfg, *args)
                p = lm_solve_plain(cfg, *args)
                torch.cuda.synchronize()
                n_eq = lm_equal(torch, k, p)
                its = sorted({int(i) for i in p[3]})
                say("K3", f"retry P={P} {dt} {n} lanes ({int(args[9].sum())} "
                          f"active, n_iter {its[0]}..{its[-1]}, "
                          f"{len(its)} distinct): u, chi2, conv, n_iter and "
                          f"lambda equal on {n_eq}")
                check(n_eq == n, f"K3 retry not bit-equal at P={P} {dt} "
                                 f"n={n}")


def ladder_inputs(torch, cfg, cal, n, max_pulses, P, seed, dtype, dev, cut):
    """The ladder launch's inputs for n lanes: lm_inputs' lanes with seeds
    jittered 3.5 bins and noise 1.0, the configuration's stage-1 and
    stage-2 budgets and caps. With ``cut``, lanes reach every rung: lane i
    is inactive when i % 5 == 2, its stage-1 budget is i % 4 iterations,
    its stage-2 budget 0 when i % 7 == 3, 2 when i % 3 == 0."""
    (coeffs, x0, y, w, u0, lo, hi, p_seed, pm, active, s1_cap, _,
     s1_budget) = lm_inputs(torch, cfg, cal, n, max_pulses, P, seed, dtype,
                            dev, noise=1.0, seed_jitter=3.5)
    wide = pm[:, 2::2].sum(dim=1) > cfg.lm_wide_pulses
    s2_budget = torch.where(wide, cfg.lm_stage2_wide,
                            cfg.lm_max_iter_stage2).to(torch.int32)
    if cut:
        idx = torch.arange(n, device=dev)
        active = idx % 5 != 2
        s1_budget = (idx % 4).to(torch.int32)
        s2_budget = torch.where(idx % 7 == 3, 0, torch.where(
            idx % 3 == 0, 2, s2_budget)).to(torch.int32)
    return (coeffs, x0, y, w, u0, lo, hi, p_seed, pm, active, s1_cap,
            s1_budget, max(cfg.lm_max_iter_stage2, cfg.lm_stage2_wide),
            s2_budget)


def host_ladder_kernel(torch, cfg, args):
    """Stage 1 and the rungs as the host ran them before the ladder launch:
    fit.lm.host_ladder over lm_solve_kernel, a launch a rung on the
    gathered lanes. Returns lm_ladder_kernel's tuple."""
    from npswf_tpu_torch.fit.lm import host_ladder
    from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel
    (coeffs, x0, y, w, u0, lo, hi, p_seed, pm, active, s1_cap, s1_budget,
     s2_cap, s2_budget) = args

    def solve(lanes, u, act, max_iter, lam0, budget):
        c, x, y_, w_, lo_, hi_, ps, pm_ = lanes
        return lm_solve_kernel(cfg, c, x, y_, w_, u, lo_, hi_, ps, pm_, act,
                               max_iter, lam0, budget)
    *stages, rungs = host_ladder(cfg, solve, (coeffs, x0, y, w, lo, hi,
                                              p_seed, pm),
                                 u0, pm, active, s1_cap, s1_budget, s2_cap,
                                 s2_budget)
    return (*stages, torch.tensor(rungs, dtype=torch.int32, device=u0.device))


def check_lm_ladder(torch, cfg, cal, dev, records, card):
    """K3's ladder launch (lm_ladder_kernel) against its plain version, the
    host ladder over lm_solve_plain: stage 1's u, chi2, conv, n_iter and
    edm, the rungs' u, chi2, conv and n_iter and the lanes each rung
    retried equal at P = 2, 4 and 12, both types, on 1, 37 and 301 lanes
    with cut budgets (inactive lanes, budgets of 0, every rung reached on
    301) and on 69,120 with the configuration's. The 69,120-lane P = 2 fp32
    launch is timed against stage 1 and the rungs as the host ran them
    (host_ladder_kernel), whose results it equals too. A configuration of
    nine pull-backs is held to its plain version at P = 2 on 301 lanes."""
    from npswf_tpu_torch.fit.lm_kernel import lm_ladder_kernel, lm_ladder_plain
    big = cal.nblocks * E_BENCH
    for P, max_pulses in ((2, 2), (4, 4), (12, 6)):
        for dt in (torch.float64, torch.float32):
            for n in (1, 37, 301, big):
                args = ladder_inputs(torch, cfg, cal, n, max_pulses, P,
                                     91 + n + P, dt, dev, cut=n < big)
                k = lm_ladder_kernel(cfg, *args)
                p = lm_ladder_plain(cfg, *args)
                torch.cuda.synchronize()
                n_eq = lm_equal(torch, k, p, range(9))
                rk, rp = k[9].tolist(), p[9].tolist()
                its = k[3] + k[8]
                say("K3", f"ladder P={P} {dt} {n} lanes "
                          f"({int(args[9].sum())} active, stage 1 converged "
                          f"{int(k[2].sum())}, rungs' lanes {rk}, plain "
                          f"{rp}, iterations {int(its.min())}.."
                          f"{int(its.max())}): stage 1 and rungs equal on "
                          f"{n_eq}")
                check(n_eq == n and rk == rp, f"K3 ladder not bit-equal to "
                                              f"its plain version at P={P} "
                                              f"{dt} n={n}")
                if n == 301:
                    check(all(rp), f"a rung got no lanes at P={P} {dt}")
                if n == big and P == 2 and dt == torch.float32:
                    h = host_ladder_kernel(torch, cfg, args)
                    check(lm_equal(torch, k, h, range(9)) == n
                          and h[9].tolist() == rk,
                          "K3 ladder differs from the host's rungs over K3")
                    fused_ms = cuda_ms(torch, lambda: lm_ladder_kernel(
                        cfg, *args), 5)
                    host_ms = cuda_ms(torch, lambda: host_ladder_kernel(
                        torch, cfg, args), 5)
                    records["lm_solve"].update(ladder_ms=fused_ms,
                                               host_ladder_ms=host_ms)
                    say("K3", f"ladder P=2 fp32, {n} lanes: one launch "
                              f"{fused_ms:.4f} ms; stage 1 and the rungs "
                              f"as the host ran them (a launch a rung) "
                              f"{host_ms:.4f} ms ({card})")
                del args, k, p
    # nine pull-backs: the launch reads their values from the card's memory
    many = cfg.replace(lm_stage3_pullbacks=tuple(
        0.9 - 0.05 * i for i in range(9)))
    for dt in (torch.float64, torch.float32):
        args = ladder_inputs(torch, many, cal, 301, 2, 2, 395, dt, dev,
                             cut=True)
        k = lm_ladder_kernel(many, *args)
        p = lm_ladder_plain(many, *args)
        torch.cuda.synchronize()
        n_eq = lm_equal(torch, k, p, range(9))
        rk, rp = k[9].tolist(), p[9].tolist()
        say("K3", f"ladder P=2 {dt} 301 lanes, 9 pull-backs: rungs' lanes "
                  f"{rk}, plain {rp}: stage 1 and rungs equal on {n_eq}")
        check(n_eq == 301 and rk == rp and len(rk) == 10,
              f"K3 ladder with 9 pull-backs not bit-equal to its plain "
              f"version at {dt}")


def time_lm_launches(torch, cfg, calib, batch, records, card):
    """K3 per launch on the default route: the ladder launches of one
    process_batch (one a fitted bucket) are captured with their arguments,
    then each is timed alone."""
    from npswf_tpu_torch.engine.pipeline import process_batch_eager
    from npswf_tpu_torch.fit import lm_kernel
    kernel = lm_kernel.lm_ladder_kernel
    calls = []

    def capture(cfg_, *args):
        calls.append((cfg_, args))
        return kernel(cfg_, *args)
    lm_kernel.lm_ladder_kernel = capture
    try:
        # the eager body: a graph's replay calls no Python
        process_batch_eager(cfg, calib, batch)
        torch.cuda.synchronize()
    finally:
        lm_kernel.lm_ladder_kernel = kernel
    check(len(calls) == records["lm_solve"]["launches"],
          f"{len(calls)} K3 ladder calls captured, "
          f"{records['lm_solve']['launches']} launches counted on the "
          "default route")
    per = []
    for c, args in calls:
        out = kernel(c, *args)
        ms = cuda_ms(torch, lambda: kernel(c, *args), 5)
        # the iterations of every stage and rung
        spent = (*out[:3], out[3] + out[8], *out[4:])
        rec = {"call": "ladder", "lanes": int(args[4].shape[0]),
               "P": (args[4].shape[1] - 1) // 2,
               "budget_caps": [int(args[10]), int(args[12])],
               "rung_lanes": out[9].tolist(), "ms": ms,
               **lm_bound(torch, c, args[:10], spent)}
        per.append(rec)
        say("K3", f"default route, ladder at P={rec['P']}: {rec['lanes']} "
                  f"lanes, rungs' lanes {rec['rung_lanes']}, budget caps "
                  f"{rec['budget_caps']}: {ms:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) ({card})")
    records["lm_solve"]["route_launches"] = per
    say("K3", f"default route: {sum(r['ms'] for r in per):.4f} ms over "
              f"{len(per)} launches ({card})")


# ---------------------------------------------------------------------
# [graph]: process_batch as CUDA graph replays against the eager body
# ---------------------------------------------------------------------
# (tag, NPSConfig fields, make_events keywords, dtype); GRAPH_POOL batches
# each, seeds 21, 22, ...
GRAPH_KINDS = (
    ("dense", {}, dict(occupancy=1.0, max_pulses=2, pileup_prob=0.25),
     "float32"),
    ("pileup", {}, dict(occupancy=1.0, max_pulses=4, pileup_prob=0.9),
     "float32"),
    ("fp64", {}, dict(occupancy=1.0, max_pulses=2, pileup_prob=0.25),
     "float64"),
    ("sparse", dict(search_capacity=8640),
     dict(occupancy=0.05, max_pulses=2, pileup_prob=0.3), "float32"),
    # capped buckets: _front's lanes, n_fit_dropped on the device
    ("capped", dict(fit_capacity=8640),
     dict(occupancy=1.0, max_pulses=4, pileup_prob=0.9), "float32"),
)
GRAPH_POOL = 3


def same_output(torch, a, b):
    """The fields of two PipelineOutputs that differ (dtype, shape or a
    value; NaN equal to NaN)."""
    differ = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape or not bool(
                ((x == y) | (x.isnan() & y.isnan())
                 if x.is_floating_point() else (x == y)).all()):
            differ.append(f)
    return differ


def graph_pool(torch, dev, kind, seed0=21):
    """[graph]'s batches of one kind: (cfg, calibration tensors, batches)."""
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
    from npswf_tpu_torch.utils.synthetic import make_events
    tag, fields, events, dt_name = kind
    dt = getattr(torch, dt_name)
    cfg = NPSConfig(compute_dtype=dt_name, **fields)
    cal = synthetic_calibration(cfg.replace(compute_dtype="float32"), seed=1)
    batches = []
    for i in range(GRAPH_POOL):
        truth = make_events(cfg, cal, E_BENCH, seed=seed0 + i, **events)
        corr = np.random.default_rng(seed0 + i).uniform(-2, 2, E_BENCH)
        pres = (truth.npulse > 0) if tag == "sparse" else truth.pres
        batches.append(batch_to_torch(truth.signal.astype(np.float32), pres,
                                      corr.astype(np.float32), dev, dt))
    return cfg, cal, calib_to_torch(cal.device_arrays(cfg), dev, dt), batches


def counted(torch, fn):
    """fn()'s answer, its launches, the program's counters but the call's
    own and the graphs', and every counter."""
    from npswf_tpu_torch import kernels
    kernels.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.counts.items()
              if k != "engine.process_batch"
              and not k.startswith("engine.graph_")}
    return out, dict(kernels.launches), counts, dict(kernels.counts)


def call_kernels(torch, fn):
    """The device kernels of a call of ``fn``, sorted by name: the second
    of two calls under torch.profiler, taken as the kernels that start
    after a marker kernel (``torch.cuda._sleep``) launched just before it
    ends, both on the device's clock (the host's clock is offset from it),
    with no copy, fill of memory or span of the program."""
    cuda = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100000)
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == cuda]
    marks = [e.time_range.end for e in device if "spin_kernel" in e.name]
    check(marks, "[graph] the profiler shows no marker kernel")
    t0 = max(marks)
    return sorted(e.name for e in device
                  if e.time_range.start >= t0 and not e.name.startswith(
                      ("npswf.", "chip_smoke."))
                  and not any(c in e.name for c in ("Memcpy", "Memset",
                                                    "memcpy", "memset")))


def check_graph(torch, dev, card):
    """The [graph] phase: process_batch on the graph route (two CUDA graph
    replays around one read of the bucket sizes) against its eager body on
    a dense, a pileup, an fp64 and a sparse-readout batch under
    search_capacity 8,640, and a pileup batch under fit_capacity 8,640
    (capped buckets), GRAPH_POOL batches of each in turns (the input
    pointers differ), twice round, then after a calibration swap and back:
    every field bit-equal, every replay's launches and counters equal to
    the eager call's; under torch.profiler one replay's device kernels
    equal the eager call's, K2 and K3 among them; host ms a call, eager
    and replayed."""
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.engine import graphs, pipeline
    summary = {}
    for kind in GRAPH_KINDS:
        tag = kind[0]
        cfg, cal, calib, batches = graph_pool(torch, dev, kind)
        check(pipeline.graph_route(cfg, dev), f"[graph] {tag}: not routed "
                                               "to the graphs")
        graphs.clear()
        # what runs once a process (the search's taps) before the counts
        pipeline.process_batch_eager(cfg, calib, batches[0])
        cal2 = synthetic_calibration(cfg.replace(compute_dtype="float32"),
                                     seed=2)
        calib2 = calib_to_torch(cal2.device_arrays(cfg), dev,
                                batches[0].signal.dtype)
        order = [(i, calib) for i in range(GRAPH_POOL)] * 2 + [
            (0, calib2), (1, calib2), (0, calib)]
        replays = 0
        for n, (i, cb) in enumerate(order):
            b = batches[i]
            ref, launches_e, counts_e, _ = counted(
                torch, lambda: pipeline.process_batch_eager(cfg, cb, b))
            out, launches_g, counts_g, every = counted(
                torch, lambda: pipeline.process_batch(cfg, cb, b))
            differ = same_output(torch, out, ref)
            check(not differ, f"[graph] {tag} call {n} (batch {i}): fields "
                              f"differ from the eager body: {differ}")
            replayed = every.get("engine.graph_replays", 0)
            check(replayed == (0 if n == 0 else 1),
                  f"[graph] {tag} call {n}: {replayed} replays")
            replays += replayed
            check(launches_g == launches_e and counts_g == counts_e,
                  f"[graph] {tag} call {n}: counted {launches_g} {counts_g}, "
                  f"the eager body {launches_e} {counts_e}")
        b = batches[1]
        ke = call_kernels(
            torch, lambda: pipeline.process_batch_eager(cfg, calib, b))
        kg = call_kernels(torch, lambda: pipeline.process_batch(cfg, calib, b))
        only_e = collections.Counter(ke) - collections.Counter(kg)
        only_g = collections.Counter(kg) - collections.Counter(ke)
        check(ke == kg, f"[graph] {tag}: the profiler shows {len(kg)} "
                        f"kernels a replay, {len(ke)} an eager call; only "
                        f"eager: {dict(only_e)}; only replayed: "
                        f"{dict(only_g)}")
        check(any("lm_kernel<" in n for n in kg)
              and any("search_kernel<" in n for n in kg),
              f"[graph] {tag}: K2 or K3 missing from a replay's kernels")

        def ms(fn):
            fn()
            torch.cuda.synchronize()
            t = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(t))
        ms_e = ms(lambda: pipeline.process_batch_eager(cfg, calib, b))
        ms_g = ms(lambda: pipeline.process_batch(cfg, calib, b))
        summary[tag] = {"calls": len(order), "replays": replays,
                        "kernels": len(kg), "eager_ms": ms_e,
                        "replay_ms": ms_g}
        say("graph", f"{tag}: {len(order)} calls over {GRAPH_POOL} batches "
                     f"and two calibrations bit-equal to the eager body, "
                     f"{replays} by replay with its counts; {len(kg)} "
                     f"kernels a call on both; host {ms_e:.3f} ms eager, "
                     f"{ms_g:.3f} ms replayed ({card})")
    graphs.clear()
    return summary


def eval_inputs(torch, cfg, cal, n, P, seed, dtype, dev):
    """fused_eval inputs drawn as tests/test_pallas.py:52-59 does: times
    over [-60, 95] (the segment-slot wrap included), amplitudes 10..200,
    80% of the pulse slots active."""
    from npswf_tpu_torch.fit.eval_kernel import pad_coeffs
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, cfg.nblocks, n)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    return (pad_coeffs(t(cal.spline_coeffs[blocks])), t(cal.spline_x0[blocks]),
            t(rng.uniform(-60, 95, (n, P))), t(rng.uniform(10, 200, (n, P))),
            t(rng.uniform(-5, 5, n)),
            torch.as_tensor(rng.random((n, P)) < 0.8, device=dev))


def check_fused_eval(torch, cfg, cal, dev, records):
    """K5 against its plain version at P = 2, 4 and 12: bit-equal at both
    types."""
    from npswf_tpu_torch.fit.eval_kernel import fused_eval, fused_eval_plain
    n = cal.nblocks * E_BENCH
    K = cfg.nfitbins
    for P in (2, 4, 12):
        for dt in (torch.float64, torch.float32):
            args = eval_inputs(torch, cfg, cal, n, P, 31 + P, dt, dev)
            k = fused_eval(cfg, *args)
            p = fused_eval_plain(cfg, *args)
            torch.cuda.synchronize()
            ndiff = [int((x != y).sum()) for x, y in zip(k, p)]
            err = max(float((x - y).abs().max()) for x, y in zip(k, p))
            say("K5", f"P={P} {dt}: values differing bitwise (f, Jt, Ja) "
                      f"{ndiff} of ({n * K}, {n * P * K}, {n * P * K}); "
                      f"max|d| {err:.3e}")
            check(sum(ndiff) == 0, f"fused_eval not bit-equal at P={P} {dt}")
            if P == 2 and dt == torch.float32:
                records["fused_eval"].update(
                    max_abs_err=err,
                    ms=cuda_ms(torch, lambda: fused_eval(cfg, *args), 20),
                    plain_ms=cuda_ms(torch, lambda: fused_eval_plain(cfg, *args), 5),
                    library_ms=None,
                    **bound(nbytes(*args, *k), n * K * (25 * P + 1)))
            del args, k, p


def system_inputs(torch, cfg, cal, n, P, max_pulses, seed, dtype, dev):
    """K6's arguments on LM inputs at a point perturbed by +-0.3 in u, and
    for P <= NARROW_P K7's (K5's outputs at that point and dp/du), else
    None. y is a window of the signal rows (a row stride of ntime), as the
    pipeline passes it."""
    from npswf_tpu_torch.fit.eval_kernel import (NARROW_P, dp_du, fused_eval,
                                                 to_physical)
    (coeffs_pad, x0, y, w, u0, lo, hi, p_seed, pm, _, _, _, _) = \
        lm_inputs(torch, cfg, cal, n, max_pulses, P, seed, dtype, dev)
    rng = np.random.default_rng(seed + 10)
    u = u0 + torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(u0.shape)),
                             dtype=dtype, device=dev)
    sys_args = (coeffs_pad, x0, y, w, u, lo, hi, p_seed, pm)
    if P > NARROW_P:
        return sys_args, None
    pp = to_physical(u, lo, hi, p_seed, pm)
    ev = fused_eval(cfg, coeffs_pad, x0, pp[:, 1::2], pp[:, 2::2], pp[:, 0],
                    pm[:, 2::2])
    return sys_args, (y, w, *ev, dp_du(u, lo, hi, pm))


def device_activities(torch, fn):
    """Names of the device activities (kernels, copies, fills) of one call
    of ``fn``, from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_ms(torch, fn, reps, name):
    """Mean device time of the kernel whose name holds ``name`` over
    ``reps`` calls of ``fn`` (torch.profiler, after one warm-up call): the
    kernel alone, without the wrapper's host time. None when the profiler
    records no device activity."""
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(us) / 1e3 / len(us) if us else None


# K6 at the widths of the buckets chip_smoke drives (1, 2, 4, the middle 5,
# the wide 10 and 12) and 3, K7 at those up to NARROW_P: (P, max_pulses of
# the lanes)
SYSTEM_WIDTHS = ((1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (10, 6), (12, 6))
# K6 past a tile of one lane (one lane a block, its sums through the
# outputs), on WIDE_LANES lanes: A alone is 69,120 x 181^2 values at P = 90
SYSTEM_WIDE = ((61, 8), (62, 8), (84, 8), (90, 8))
SYSTEM_WIDE_TIMED = (62, 90)


def system_bound(torch, name, args, out, P):
    """K6's or K7's bound: its tensors read and written once; K6's
    operations those of one system evaluation a lane, K7's the columns and
    the products and sums."""
    n, K = args[2].shape if name == "fused_system" else args[0].shape
    M = 1 + 2 * P
    nops = (n * ops_system(K, P) if name == "fused_system"
            else n * K * (6 * P + M * (M + 1) + 2 * M + 5))
    return bound(nbytes(*args, *out), nops)


def check_systems(torch, cfg, cal, dev, records, card):
    """K6 at P = 1-5, 10, 12 and K7 at P = 1..4 against their plain
    versions at N = 69,120 lanes, and K6 at SYSTEM_WIDE on WIDE_LANES
    lanes, bit-equal at both types. At P = 2 fp32 (and K6 at P = 12 and
    SYSTEM_WIDE_TIMED) each is timed as a wrapper call (CUDA events) and
    as the kernel alone (the profiler's device time)."""
    from npswf_tpu_torch.fit.eval_kernel import (fused_neq, fused_neq_plain,
                                                 fused_system,
                                                 fused_system_plain,
                                                 system_layout)
    for P, max_pulses in SYSTEM_WIDTHS + SYSTEM_WIDE:
        n = (WIDE_LANES if (P, max_pulses) in SYSTEM_WIDE
             else cal.nblocks * E_BENCH)
        for dt in (torch.float64, torch.float32):
            sys_args, neq_args = system_inputs(torch, cfg, cal, n, P,
                                               max_pulses, 41 + P, dt, dev)
            cases = [("K6", "fused_system", sys_args,
                      lambda: fused_system(cfg, *sys_args),
                      lambda: fused_system_plain(cfg, *sys_args))]
            if neq_args is not None:
                cases.append(("K7", "fused_neq", neq_args,
                              lambda: fused_neq(cfg, *neq_args),
                              lambda: fused_neq_plain(cfg, *neq_args)))
            for tag, name, args, run_k, run_p in cases:
                k, p = run_k(), run_p()
                torch.cuda.synchronize()
                ndiff = sum(n_unequal(torch, x, y_) for x, y_ in zip(k, p))
                err = max_abs_diff(torch, zip(k, p))
                say(tag, f"P={P} {dt} {n} lanes: {ndiff} values of A, g, "
                         f"chi2 differ bitwise; max|d| {err:.3e}")
                if tag == "K6":
                    layout = system_layout(P, cfg.nfitbins, dt)
                    say(tag, f"P={P} {dt}: layout {layout}")
                    check(layout == (1 if P > 61 else 0),
                          f"{name} at P={P} {dt} took layout {layout}")
                check(all(bool(torch.isfinite(x).all()) for x in k),
                      f"{name} not finite")
                check(ndiff == 0, f"{name} not bit-equal at P={P} {dt}")
                if dt == torch.float32 and (P == 2 or (
                        tag == "K6" and P in (12,) + SYSTEM_WIDE_TIMED)):
                    kname = "system_kernel" if tag == "K6" else "neq_kernel"
                    t = dict(max_abs_err=err,
                             ms=cuda_ms(torch, run_k, 20),
                             kernel_ms=kernel_ms(torch, run_k, 20, kname),
                             plain_ms=cuda_ms(torch, run_p, 3),
                             **system_bound(torch, name, args, k, P))
                    kms = ("not measured" if t["kernel_ms"] is None
                           else f"{t['kernel_ms']:.4f} ms")
                    say(tag, f"P={P} fp32, {n} lanes: wrapper {t['ms']:.4f} "
                             f"ms, kernel alone {kms}, plain "
                             f"{t['plain_ms']:.4f} ms, bound "
                             f"{t['bound_ms']:.4f} ms ({t['bound_by']}) "
                             f"({card})")
                    if P == 2:
                        if name == "fused_neq":
                            t["library_ms"] = bmm_ms(torch, *args)
                        else:
                            t["library_ms"] = None
                        records[name].update(t)
                    else:
                        records[name][f"p{P}"] = dict(t, lanes=n)
                del k, p
            del sys_args, neq_args, cases


def bmm_ms(torch, y, w, f, jt, ja, dd):
    """Yardstick for K7: one batched product of X = [Ju | r] gives A, g and
    chi2 (the port never calls it)."""
    n, P, K = jt.shape
    jp = torch.stack([jt, ja], dim=2).reshape(n, 2 * P, K)
    cols = torch.cat([dd[:, :1, None].expand(n, 1, K),
                      jp * dd[:, 1:, None]], dim=1) * w[:, None, :]
    X = torch.cat([cols, ((y - f) * w)[:, None, :]],
                  dim=1).transpose(1, 2).contiguous()
    return cuda_ms(torch, lambda: torch.bmm(X.mT, X), 20)


# ---------------------------------------------------------------------
# the routes of process_batch
# ---------------------------------------------------------------------
def check_output(torch, cfg, calib, truth, batch, out, route):
    """Shapes, finite values, failure rate and fit times against truth."""
    E, B, T = batch.signal.shape
    for f, v in out._asdict().items():
        check(tuple(v.shape[:2]) in ((E, B), (E,), ()), f"{f} shape {v.shape}")
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{route}: {f} not finite")
    n_succ, n_fail = int(out.n_fit_success), int(out.n_fit_failure)
    rate = n_fail / max(n_succ + n_fail, 1)
    # truth: single-pulse blocks found with one pulse and fitted
    t_rel = (out.wftime[..., 0] - batch.corr_time_HMS[:, None]
             + calib["cortime"][None, :] + calib["timerefacc"] * cfg.dt) / cfg.dt
    one = (torch.as_tensor(truth.npulse, device=out.wfnpulse.device) == 1) \
        & (out.wfnpulse == 1) & out.fit_converged
    dt_bins = (t_rel + calib["timeref"][None, :]
               - torch.as_tensor(truth.times[..., 0], device=t_rel.device,
                                 dtype=t_rel.dtype))[one].abs()
    med = float(dt_bins.median())
    say(route, f"pulses {int(out.wfnpulse.sum())}, fits ok {n_succ}, failed "
               f"{n_fail} ({rate:.4%}), dropped {int(out.n_fit_dropped)}; "
               f"single-pulse blocks {int(one.sum())}: median |t_fit - "
               f"t_true| {med:.4f} bins")
    check(rate <= FAIL_RATE_MAX, f"{route}: failure rate {rate:.4%} above 2%")
    check(int(one.sum()) > E * B // 2 and med < 0.05,
          f"{route}: fit times off truth")


def run_route(torch, cfg, calib, truth, batch, route, card, default_out):
    """One route of process_batch through its kernels: launch counts read
    around this run alone, the checks, then times against the plain path."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.engine.pipeline import process_batch
    E, B, T = batch.signal.shape
    must, zero = ROUTES[route]
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = process_batch(cfg, calib, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    plain = dict(kernels.plain_calls)
    say(route, f"process_batch E={E} B={B} T={T} fp32 in {first_s:.3f} s; "
               f"launches {launches}; plain calls {plain}")
    for name in must:
        check(launches.get(name, 0) > 0, f"{route}: kernel {name} not launched")
    for name in zero:
        check(launches.get(name, 0) == 0, f"{route}: kernel {name} launched")
    check(sum(plain.values()) == 0, f"{route}: a plain version ran on the "
                                    "kernel path")
    check_output(torch, cfg, calib, truth, batch, out, route)
    if default_out is not None:
        np_diff = int((out.wfnpulse != default_out.wfnpulse).sum())
        gate_diff = int((out.gate != default_out.gate).sum())
        conv_flip = int((out.fit_converged != default_out.fit_converged).sum())
        n_conv = int(default_out.fit_converged.sum())
        say(route, f"vs the default route: wfnpulse differs on {np_diff}, "
                   f"gate on {gate_diff}, fit_converged on {conv_flip} of "
                   f"{E * B} ({n_conv} converged there)")
        check(np_diff == 0 and gate_diff == 0,
              f"{route}: wfnpulse/gate differ from the default route")
        # the flip band of tests/test_routing.py: two summation orders
        check(conv_flip <= max(4, n_conv // 50),
              f"{route}: fit_converged flips beyond the band")
    def timed(plain):
        """Host clock around one synchronized batch, in ms."""
        t0 = time.perf_counter()
        res = process_batch(cfg, calib, batch, plain=plain)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3
    ref, t_plain = timed(True)
    np_diff = int((out.wfnpulse != ref.wfnpulse).sum())
    gate_diff = int((out.gate != ref.gate).sum())
    conv_diff = int((out.fit_converged != ref.fit_converged).sum())
    say(route, f"vs plain path on the card: wfnpulse differs on {np_diff}, "
               f"gate on {gate_diff}, fit_converged on {conv_diff} of {E * B}")
    check(np_diff == 0 and gate_diff == 0, f"{route}: wfnpulse/gate differ "
                                           "from plain")

    # kernel path: median of 5 after a warm-up; plain path: median of the
    # reference run above and one more
    timed(False)
    ms_k = float(np.median([timed(False)[1] for _ in range(5)]))
    ms_p = float(np.median([t_plain, timed(True)[1]]))
    for name, ms in (("kernel path", ms_k), ("plain path", ms_p)):
        say("times", f"{route} {name}: {ms:.3f} ms per {E}-event batch, "
                     f"{E * B / (ms / 1e3):.0f} blocks/s ({card})")
    return out, launches, ms_k


def small_reference(torch, dev, flags):
    """fp64 on a small batch: every decision of the kernel path equals the
    plain path's on the card, under the route's configuration."""
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
    from npswf_tpu_torch.engine.pipeline import process_batch
    from npswf_tpu_torch.utils.synthetic import make_events
    cfg = NPSConfig(ncol=5, nlin=6, fit_small_pulses=1, fit_mid_pulses=2,
                    **flags)
    cal = synthetic_calibration(cfg, seed=2)
    truth = make_events(cfg, cal, 4, occupancy=0.4, max_pulses=4,
                        pileup_prob=0.9, seed=5)
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float64)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(4), dev,
                           torch.float64)
    k = process_batch(cfg, calib, batch)
    p = process_batch(cfg, calib, batch, plain=True)
    for f in ("wfnpulse", "pulse_valid", "gate", "fit_converged", "fit_n_iter"):
        check(torch.equal(getattr(k, f), getattr(p, f)),
              f"small fp64 {f} differs under {flags}")
    check(bool(torch.allclose(k.wftime, p.wftime, rtol=1e-9, atol=1e-9)),
          f"small fp64 wftime differs under {flags}")
    return int(k.fit_converged.sum())


# ---------------------------------------------------------------------
# the fit buckets: every width the configurations below route lanes to
# ---------------------------------------------------------------------
# NPSConfig changes and the bucket widths that must carry lanes of the
# pileup-heavy batch. The search emits at most 4 pulses a block on the
# reference template (core/config.py, pallas_lm_max_pulses), so the bucket
# bounds, not the batch, send lanes to the wide widths.
BUCKET_CONFIGS = (
    ({}, (2, 4)),
    (dict(fit_small_pulses=1, fit_mid_pulses=2), (1, 2, 12)),
    (dict(fit_small_pulses=1, fit_mid_pulses=5), (1, 5)),
    (dict(fit_small_pulses=2, fit_mid_pulses=2, maxwfpulses=10), (2, 10)),
)
# route -> the kernel that solves each bucket on it
BUCKET_ROUTES = {"default": "lm_solve", "fused_system": "fused_system"}


def run_buckets(torch, cfg, calib, batch):
    """process_batch's eager body (a graph's replay calls no Python) with
    each bucket's fit counted: per bucket (in the pipeline's order) its
    width, active lanes, failed fits and the kernel launches of its fit."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.engine import pipeline
    fit = pipeline.fit_waveforms
    rows = []

    def counted(cfg_, inp, *args, **kw):
        before = dict(kernels.launches)
        res = fit(cfg_, inp, *args, **kw)
        rows.append({"P": int(inp.t_seed.shape[1]),
                     "lanes": int(inp.active.sum()),
                     "failed": int((inp.active & ~res.converged).sum()),
                     "launches": {k: v - before.get(k, 0)
                                  for k, v in kernels.launches.items()
                                  if v > before.get(k, 0)}})
        return res
    pipeline.fit_waveforms = counted
    try:
        kernels.reset_counts()
        out = pipeline.process_batch_eager(cfg, calib, batch)
        torch.cuda.synchronize()
    finally:
        pipeline.fit_waveforms = fit
    return out, rows, dict(kernels.plain_calls)


def pileup_batch(torch, dev, dtype=None):
    """A 64-event batch of bench shape with up to 4 pulses a block and
    pileup 0.9 (seed 13), fp32 (or ``dtype``): (NPSConfig, calibration
    tensors, batch)."""
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
    from npswf_tpu_torch.utils.synthetic import make_events
    dt = torch.float32 if dtype is None else dtype
    base = NPSConfig(compute_dtype=str(dt).split(".")[1])
    cal = synthetic_calibration(base.replace(compute_dtype="float32"), seed=1)
    truth = make_events(base, cal, E_BENCH, occupancy=1.0, max_pulses=4,
                        pileup_prob=0.9, seed=13)
    corr = np.random.default_rng(11).uniform(-2, 2, E_BENCH).astype(np.float32)
    batch = batch_to_torch(truth.signal.astype(np.float32), truth.pres, corr,
                           dev, dt)
    return base, calib_to_torch(cal.device_arrays(base), dev, dt), batch


def check_bucket_run(torch, phase, tag, cfg, calib, batch, widths, kernel,
                     card):
    """One bucket configuration through run_buckets: every named width
    carries lanes and is solved by ``kernel``, no plain call, and wfnpulse,
    gate and fit_converged equal the plain path's on the card. (Summary,
    output.)"""
    from npswf_tpu_torch.engine.pipeline import process_batch
    E, B, _ = batch.signal.shape
    t0 = time.perf_counter()
    out, rows, plain = run_buckets(torch, cfg, calib, batch)
    ms = (time.perf_counter() - t0) * 1e3
    ref = process_batch(cfg, calib, batch, plain=True)
    diff = {f: int((getattr(out, f) != getattr(ref, f)).sum())
            for f in ("wfnpulse", "gate", "fit_converged")}
    n_fail = int(out.n_fit_failure)
    rate = n_fail / max(int(out.n_fit_success) + n_fail, 1)
    for r in rows:
        say(phase, f"{tag}: P={r['P']}: {r['lanes']} lanes, "
                   f"{r['failed']} failed "
                   f"({r['failed'] / max(r['lanes'], 1):.4%}), "
                   f"launches {r['launches']}")
    say(phase, f"{tag}: {ms:.1f} ms, failure rate {rate:.4%}; against the "
               f"plain path on the card, values differing {diff} of "
               f"{E * B} ({card})")
    check(not plain, f"[{phase}] {tag}: plain versions ran: {plain}")
    check(not any(diff.values()), f"[{phase}] {tag}: differs from the plain "
                                  f"path: {diff}")
    carried = {r["P"] for r in rows if r["lanes"] > 0}
    check(set(widths) <= carried, f"[{phase}] {tag}: widths "
                                  f"{sorted(set(widths) - carried)} carried "
                                  f"no lanes")
    for r in rows:
        check(r["lanes"] == 0 or r["launches"].get(kernel, 0) > 0,
              f"[{phase}] {tag}: P={r['P']} not solved by {kernel}")
        # K3 at a compiled width runs a bucket's whole ladder in one launch
        check(kernel != "lm_solve" or r["P"] > 15 or r["lanes"] == 0
              or r["launches"].get(kernel) == 1,
              f"[{phase}] {tag}: P={r['P']}: {r['launches'].get(kernel)} "
              f"K3 launches, not one")
    return {"ms": ms, "failure_rate": rate, "buckets": rows,
            "differ_from_plain": diff}, out


def check_buckets(torch, dev, card):
    """The [buckets] phase: the pileup batch through process_batch under
    each of BUCKET_CONFIGS, on the default route (K3) and on
    use_fused_system (K6; its LM budgets cut as WIDE_PATH_BUDGETS), each
    through check_bucket_run."""
    base, calib, batch = pileup_batch(torch, dev)
    summary = []
    for changes, widths in BUCKET_CONFIGS:
        for route, kernel in BUCKET_ROUTES.items():
            cfg = base.replace(**changes, **ROUTE_FLAGS[route],
                               **WIDE_PATH_BUDGETS.get(route, {}))
            tag = f"{route} {changes or 'NPSConfig()'}"
            summary.append(dict(route=route, changes=changes, **check_bucket_run(
                torch, "buckets", tag, cfg, calib, batch, widths, kernel,
                card)[0]))
    return summary


# ---------------------------------------------------------------------
# the segment executor: raw segment -> WF file
# ---------------------------------------------------------------------
def segment_chunk(args):
    """Streams and hits of one chunk of synthetic events (a worker process
    builds it: it needs numpy and the port's host layer, no torch)."""
    lo, n, occupancy, pileup, seed, sparse = args
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.tools.cli import synth_records
    from npswf_tpu_torch.utils.synthetic import make_events
    cfg = NPSConfig()
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, n, occupancy=occupancy, max_pulses=2,
                        pileup_prob=pileup, seed=seed + lo // SEG_CHUNK)
    rng = np.random.default_rng(seed + 1 + lo // SEG_CHUNK)
    return synth_records(cfg, truth, rng,
                         pres=truth.npulse > 0 if sparse else None)


_BUILT = {}   # the segments built so far ([mesh] reuses the dense one)


def build_segment_in_memory(name):
    """A raw segment of SEGMENTS[name], SEG_CHUNK events a chunk, the
    chunks built in parallel worker processes (spawned, stopped on exit)
    and never written to disk, once a run. The calibration is
    synthetic_calibration(NPSConfig(), seed=1)."""
    if name in _BUILT:
        return _BUILT[name]
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.io.rawstream import build_segment
    n_events, occupancy, pileup, seed, sparse = SEGMENTS[name]
    jobs = [(lo, min(SEG_CHUNK, n_events - lo), occupancy, pileup, seed, sparse)
            for lo in range(0, n_events, SEG_CHUNK)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        parts = pool.map(segment_chunk, jobs)
    streams = [st for s_, _ in parts for st in s_]
    hits = [h for _, h_ in parts for h in h_]
    _BUILT[name] = build_segment(
        NPSConfig(), streams, hits,
        evt=np.arange(1, n_events + 1, dtype=np.float64),
        runnum=np.full(n_events, 3000.0))
    return _BUILT[name]


def replay_batches(torch, cfg, cal, seg, dev, tmp):
    """Every batch of the segment alone through process_batch on the card,
    the launch counts read around each call: what run_segment must launch
    batch for batch. For the first two batches also the packet path's part
    (make_pipeline_packed, the batch-0 sizing) against the dense path's
    (that process_batch's host copy through WFWriter.add_batch), column for
    column. Returns {batch start: launches} and the packet kind."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.engine.pipeline import (make_pipeline_packed,
                                                 process_batch,
                                                 unflatten_packet)
    from npswf_tpu_torch.io.decode import decode_segment
    from npswf_tpu_torch.io.writer import WFWriter
    from npswf_tpu_torch.runtime.executor import (_pad_decoded, _upload_batch,
                                                  output_to_host, packet_caps)
    E, B = SEG_BATCH, cfg.nblocks
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float32)
    caps = None
    per_batch = {}
    for lo in range(0, seg.n_events, E):
        d = _pad_decoded(cfg, decode_segment(cfg, cal, seg, lo,
                                             min(lo + E, seg.n_events)), E)
        if caps is None:
            caps = packet_caps(E, B, int(d.pres[:, :B].astype(bool).sum()))
        batch = _upload_batch(cfg, d, torch.float32, dev)
        kernels.reset_counts()
        out_dev = process_batch(cfg, calib, batch)
        torch.cuda.synchronize()
        per_batch[lo] = dict(kernels.launches)
        check(not kernels.plain_calls, f"batch at {lo}: plain versions ran")
        if lo >= 2 * E:
            continue
        pack_cap, lane_cap = caps
        flat = make_pipeline_packed(cfg, calib, pack_cap, lane_cap)(batch)
        pkt, ovf = unflatten_packet(flat.cpu().numpy(), E, B, pack_cap,
                                    pres=d.pres[:, :B], lane_cap=lane_cap,
                                    P=cfg.maxwfpulses)
        check(not ovf and (lane_cap > 0 or max(int(pkt.n_wf), int(pkt.n_h))
                           <= pack_cap), f"batch at {lo}: packet overflow")
        out = output_to_host(out_dev)
        cols = []
        for i, (add, arg) in enumerate((("add_packet", pkt), ("add_batch", out))):
            w = WFWriter(cfg)
            getattr(w, add)(arg, d)
            cols.append(w.finalize(os.path.join(tmp, f"cmp{lo}_{i}.npz"),
                                   compress=False))
        differ = [k for k in cols[1] if not np.array_equal(cols[0][k], cols[1][k])]
        check(cols[0].keys() == cols[1].keys() and not differ,
              f"batch at {lo}: packet and dense parts differ in {differ}")
    return per_batch, "slab" if caps[1] > 0 else "dense"


class _Reruns(logging.Handler):
    """The batch starts the executor's dense fallback reran (its overflow
    warning names the batch)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.starts = []

    def emit(self, record):
        if "writer-packet overflow" in str(record.msg):
            self.starts.append(int(record.args[0]))


def run_segment_counted(torch, cfg, cal, seg, out, chain, dev):
    """run_segment on the card, the launch counts read around it alone and
    the batches its dense fallback reran."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.runtime.executor import run_segment
    from npswf_tpu_torch.utils.timers import StageTimer
    timers = StageTimer()
    reruns = _Reruns()
    logger = logging.getLogger("npswf")
    logger.addHandler(reruns)
    try:
        kernels.reset_counts()
        res = run_segment(cfg, cal, seg, out, batch_size=SEG_BATCH,
                          chain_batches=chain, timers=timers, device=dev)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(reruns)
    return (res, timers, dict(kernels.launches), dict(kernels.plain_calls),
            reruns.starts)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(intervals):
    return sum(b - a for a, b in intervals)


def _overlap(x, y):
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(hi - lo, 0.0)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_segment(torch, cfg, cal, seg, dev, tmp, card):
    """One run_segment under torch.profiler: the device's busy time (the
    union of kernels and copies on every stream), its idle share of the
    traced span, and how long kernels or copies of two streams ran at
    once (the two stage workers overlapping on the card)."""
    from npswf_tpu_torch.runtime.executor import run_segment
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_segment(cfg, cal, seg, os.path.join(tmp, "profiled.npz"),
                    batch_size=SEG_BATCH, device=dev, compress_output=False)
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t0) * 1e6
    streams = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.time_range.elapsed_us() > 0:
            streams.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    if not streams:
        say("segment", "profile: no device events recorded; device busy "
                       "and overlap not measured")
        return {"device_busy_ms": None}
    merged = {k: _union(v) for k, v in streams.items()}
    busy = _length(_union([iv for v in merged.values() for iv in v]))
    busiest = sorted(merged, key=lambda k: -_length(merged[k]))
    both = (_overlap(merged[busiest[0]], merged[busiest[1]])
            if len(busiest) > 1 else 0.0)
    res = {"events": seg.n_events, "span_ms": span_us / 1e3,
           "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / span_us,
           "streams": len(merged),
           "stream_busy_ms": [_length(merged[k]) / 1e3 for k in busiest],
           "two_streams_at_once_ms": both / 1e3}
    say("segment", f"profile of {seg.n_events} sparse events: span "
                   f"{res['span_ms']:.1f} ms traced, device busy "
                   f"{res['device_busy_ms']:.1f} ms (idle "
                   f"{res['idle_share']:.1%}); {len(merged)} streams, busy "
                   + ", ".join(f"{x:.1f}" for x in res["stream_busy_ms"])
                   + f" ms; the two busiest ran at once for "
                   f"{res['two_streams_at_once_ms']:.2f} ms ({card})")
    return res


def check_segments(torch, dev, card, route_ms, records, out_dir):
    """The [segment] phase: each segment through run_segment (the sparse
    one also in chains of SEG_CHAIN), checked and timed. The WF files go to
    ``out_dir`` as {name}_{chain}.npz."""
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.io.writer import read_wf
    from npswf_tpu_torch.tools.plotstats import validate
    cfg = NPSConfig()
    cal = synthetic_calibration(cfg, seed=1)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in SEGMENTS:
            t0 = time.perf_counter()
            seg = build_segment_in_memory(name)
            n_ev = seg.n_events
            n_batches = -(-n_ev // SEG_BATCH)
            say("segment", f"{name}: {n_ev} events, {seg.stream.size * 8 / 1e6:.1f} "
                           f"MB of raw stream, built in {time.perf_counter() - t0:.1f} s")
            per_batch, kind = replay_batches(torch, cfg, cal, seg, dev, tmp)
            say("segment", f"{name}: first two batches, the {kind} packet's "
                           f"parts equal the dense path's, column for column")
            k3 = [c.get("lm_solve", 0) for c in per_batch.values()]
            say("segment", f"{name}: each batch alone through process_batch: "
                           f"K3 {min(k3)}-{max(k3)} launches a batch, "
                           f"{sum(k3)} in all")
            for lo, c in per_batch.items():
                for k in ("matched_filter", "search_operands"):
                    check(c.get(k, 0) == 1, f"{name} batch at {lo}: {k} "
                                            f"launched {c.get(k, 0)} times")
                check(c.get("lm_solve", 0) >= 1,
                      f"{name} batch at {lo}: lm_solve not launched")
            runs = [1, SEG_CHAIN] if name == "sparse" else [1]
            files = {}
            for chain in runs:
                out = os.path.join(out_dir, f"{name}_{chain}.npz")
                res, timers, launches, plain, reruns = run_segment_counted(
                    torch, cfg, cal, seg, out, chain, dev)
                wf = read_wf(out)
                files[chain] = wf
                tag = f"{name} chain {chain}"
                # each batch launches what it launches alone, and a batch
                # the dense fallback reran launches it twice
                for k in ("matched_filter", "search_operands", "lm_solve"):
                    want = sum(per_batch[lo].get(k, 0)
                               for lo in [*per_batch, *reruns])
                    check(launches.get(k, 0) == want,
                          f"{tag}: {k} launched {launches.get(k, 0)} times, "
                          f"{want} expected from the batches alone and "
                          f"{len(reruns)} dense reruns")
                check(not plain, f"{tag}: plain versions ran: {plain}")
                check(validate(wf) == 0, f"{tag}: event index broken")
                check(int(wf["wf_offsets"][-1]) == int(wf["wfnpulse"].sum()),
                      f"{tag}: wf_offsets do not match wfnpulse")
                n_succ, n_fail = res.n_fit_success, res.n_fit_failure
                rate = n_fail / max(n_succ + n_fail, 1)
                check(n_succ > 0 and rate <= FAIL_RATE_MAX,
                      f"{tag}: failure rate {rate:.4%} ({n_succ} fits ok)")
                med = {st: timers.median(st) * 1e3 for st in
                       ("decode", "upload", "pipeline", "fetch", "write",
                        "interbatch", "merge")}
                # the mean gap between parts: the batch period of the loop
                # (a chain writes its parts back to back, so its median
                # gap is not one)
                period = (timers.totals["interbatch"] * 1e3
                          / max(timers.counts["interbatch"], 1))
                say("segment", f"{tag}: {n_ev} events in {res.wall_time:.3f} s, "
                               f"{res.events_per_sec:.1f} events/s, "
                               f"{res.blocks_per_sec:.0f} blocks/s; fits ok "
                               f"{n_succ}, failed {n_fail} ({rate:.4%}); "
                               f"launches {launches} over {n_batches} batches "
                               f"and {len(reruns)} dense reruns, as the "
                               f"batches alone launch ({card})")
                say("segment", f"{tag}: stage medians ms " + ", ".join(
                    f"{k} {v:.3f}" for k, v in med.items()) + "; totals s "
                    + ", ".join(f"{k} {timers.totals[k]:.3f}"
                                for k in sorted(timers.totals)))
                say("segment", f"{tag}: batch period (mean interbatch) "
                               f"{period:.3f} ms against the default route's "
                               f"process_batch {route_ms:.3f} ms a dense "
                               f"{E_BENCH}-event batch ({card})")
                summary[f"{name}_chain{chain}"] = {
                    "events": n_ev, "batches": n_batches, "packet": kind,
                    "wall_s": res.wall_time, "events_per_s": res.events_per_sec,
                    "blocks_per_s": res.blocks_per_sec, "fits_ok": n_succ,
                    "fits_failed": n_fail, "launches": launches,
                    "dense_reruns": len(reruns),
                    "stage_median_ms": med, "batch_period_ms": period,
                    "stage_total_s": dict(timers.totals),
                    "stage_calls": dict(timers.counts),
                    "default_route_ms": route_ms, "card": card}
                if name == "sparse" and chain == 1:
                    for k in ("matched_filter", "search_operands", "lm_solve"):
                        records[k]["segment_launches"] = launches.get(k, 0)
            if name == "sparse":
                summary["profile"] = profile_segment(
                    torch, cfg, cal, seg.slice(0, min(n_ev, 16 * SEG_BATCH)),
                    dev, tmp, card)
            if len(files) > 1:
                a, b = files[1], files[SEG_CHAIN]
                differ = [k for k in a if not np.array_equal(a[k], b[k])
                          or a[k].dtype != b[k].dtype]
                check(a.keys() == b.keys() and not differ,
                      f"{name}: chained file differs in {differ}")
                say("segment", f"{name}: chains of {SEG_CHAIN} write the plain "
                               f"run's file, column for column")
            del seg, files
    return summary


def cli_call(phase, *argv, expect=0):
    """One CLI subcommand in a subprocess (the card unless --cpu): its
    standard output, after checking its exit code."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "npswf_tpu_torch.tools.cli",
                          *argv], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         timeout=600)
    check(res.returncode == expect,
          f"cli {argv[0]} exited {res.returncode}, expected {expect}:"
          f"\n{res.stdout[-2000:]}{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    say(phase, f"{argv[0]}: rc {res.returncode} in "
               f"{time.perf_counter() - t0:.1f} s; "
               + (lines[-1] if lines else "(no output)"))
    return res.stdout


def fit_totals(stdout):
    """(failed, succeeded) from run's "Total failed fits: ..." line."""
    words = stdout.split("Total failed fits:")[1].split()
    return int(words[0]), int(words[4])


def check_cli(card):
    """synth -> run (the card: no --cpu) -> validate in subprocesses."""
    with tempfile.TemporaryDirectory() as tmp:
        seg, cal, out = (os.path.join(tmp, n) for n in ("s.npz", "c.npz", "o.npz"))
        cli_call("cli", "synth", "--events", str(CLI_EVENTS), "--out", seg,
                 "--calib-out", cal)
        ran = cli_call("cli", "run", "--input", seg, "--calib", cal, "--out", out)
        check("fits succeed" in ran, "cli run printed no fit totals")
        check("index OK" in cli_call("cli", "validate", out),
              "cli validate did not pass")
    say("cli", f"synth -> run on the card -> validate: index OK ({card})")


# ---------------------------------------------------------------------
# this slice's paths: the model families, K3's wide widths, the tools
# ---------------------------------------------------------------------
def gauss_truth_batch(torch, cfg, cal, width, dev, seed=3):
    """E_BENCH events of the full calorimeter whose true pulses are
    gaussians of ``width``, six blocks an event, built as
    tests/test_models.py::_gauss_batch builds them: the fp32 batch and
    (event, block) -> (delta, amp, ped)."""
    from npswf_tpu_torch.core.params import batch_to_torch
    rng = np.random.default_rng(seed)
    E, B, T = E_BENCH, cfg.nblocks, cfg.ntime
    x = np.arange(T, dtype=np.float64)
    sig = 0.3 * rng.standard_normal((E, B, T))
    truth = {}
    for e in range(E):
        for b in rng.choice(B, size=6, replace=False):
            delta = rng.uniform(-2.0, 2.0)
            amp = rng.uniform(80.0, 150.0)
            ped = rng.uniform(-3.0, 3.0)
            c = cal.timeref[b] + delta
            sig[e, b] += ped + amp * np.exp(-0.5 * ((x - c) / width) ** 2)
            truth[(e, int(b))] = (delta, amp, ped)
    batch = batch_to_torch(sig.astype(np.float32), np.ones((E, B), bool),
                           np.zeros(E, np.float32), dev, torch.float32)
    return batch, truth


def check_models(torch, cfg, cal, calib, batch, dev, card):
    """The [models] phase: the dense bench batch through process_batch with
    each family of MODEL_FAMILIES, its launches read around that run alone
    (K1 and K2, nothing of K3-K7, no plain call), its decisions against the
    plain path on the card, timed (median of 3 after a warm-up); then a
    batch of true gaussian pulses fitted with the gaussian family: on the
    gated truth lanes the fitted first-pulse time within 0.5 dt of truth
    wherever the fit converged, and the share of fits that failed within
    the 2% band (fp32 stalls a marginal lane now and then, as on the
    default route)."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.engine.pipeline import process_batch
    E, B, _ = batch.signal.shape
    summary = {}
    for family, aux in MODEL_FAMILIES.items():
        mcfg = cfg.replace(model_name=family, model_aux=aux)
        kernels.reset_counts()
        out = process_batch(mcfg, calib, batch)
        torch.cuda.synchronize()
        launches, plain = dict(kernels.launches), dict(kernels.plain_calls)
        for name in ("matched_filter", "search_operands"):
            check(launches.get(name, 0) > 0, f"[models] {family}: {name} "
                                             f"not launched")
        others = {k: v for k, v in launches.items()
                  if k not in ("matched_filter", "search_operands")}
        check(not others, f"[models] {family}: launched {others}")
        check(not plain, f"[models] {family}: plain versions ran: {plain}")
        for f, v in out._asdict().items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"[models] {family}: "
                                                     f"{f} not finite")
        ref = process_batch(mcfg, calib, batch, plain=True)
        diff = {f: int((getattr(out, f) != getattr(ref, f)).sum())
                for f in ("wfnpulse", "gate", "fit_converged")}
        check(not any(diff.values()), f"[models] {family}: differs from the "
                                      f"plain path: {diff}")

        def timed():
            t0 = time.perf_counter()
            process_batch(mcfg, calib, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        timed()
        ms = float(np.median([timed() for _ in range(3)]))
        n_succ, n_fail = int(out.n_fit_success), int(out.n_fit_failure)
        rate = n_fail / max(n_succ + n_fail, 1)
        say("models", f"{family} {dict(aux)}: launches {launches}; fits ok "
                      f"{n_succ}, failed {n_fail} ({rate:.4%}); against the "
                      f"plain path, values differing {diff} of {E * B}; "
                      f"{ms:.3f} ms per {E}-event batch (median of 3), "
                      f"{E * B / (ms / 1e3):.0f} blocks/s ({card})")
        summary[family] = {"launches": launches, "ms": ms,
                           "failure_rate": rate, "fits_ok": n_succ,
                           "fits_failed": n_fail, "differ_from_plain": diff}
    width = dict(MODEL_FAMILIES["gaussian"])["width"]
    gbatch, truth = gauss_truth_batch(torch, cfg, cal, width, dev)
    gcfg = cfg.replace(model_name="gaussian", model_aux=MODEL_FAMILIES["gaussian"])
    out = process_batch(gcfg, calib, gbatch)
    torch.cuda.synchronize()
    gate, conv = out.gate.cpu().numpy(), out.fit_converged.cpu().numpy()
    t0 = out.wftime[..., 0].cpu().numpy()
    lanes = [(e, b, delta) for (e, b), (delta, _, _) in truth.items()
             if gate[e, b]]
    err = np.array([abs(t0[e, b] - (delta * cfg.dt - cal.cortime[b]
                                    - cal.timerefacc * cfg.dt)) / cfg.dt
                    for e, b, delta in lanes if conv[e, b]])
    n_fail = len(lanes) - err.size
    say("models", f"gaussian truth batch: {len(lanes)} of {len(truth)} truth "
                  f"lanes gated, {err.size} converged, {n_fail} failed "
                  f"({n_fail / max(len(lanes), 1):.4%}); on the converged "
                  f"|t_fit - t_true| max {err.max():.4f}, median "
                  f"{np.median(err):.4f} bins ({card})")
    check(len(lanes) >= len(truth) // 2, "[models] too few truth lanes gated")
    check(n_fail <= FAIL_RATE_MAX * len(lanes),
          f"[models] {n_fail} of {len(lanes)} gaussian truth fits failed")
    check(float(err.max()) < 0.5, "[models] a fitted time is 0.5 dt off truth")
    summary["gaussian_truth"] = {"lanes": len(lanes), "failed": n_fail,
                                 "max_err_bins": float(err.max()),
                                 "median_err_bins": float(np.median(err))}
    return summary


def check_k3_wide(torch, dev, card):
    """The [k3-wide] phase: K3 at P = 13-15 (compiled widths), 16, 24, 48
    and the limit of each type (the wide unit, P at run time) on check_lm's
    inputs (WIDE_LANES lanes; the calls at the limit cut to
    WIDE_LIMIT_ITERS iterations; tests/test_torch_package.py has the
    retry-shaped calls), both types, u, chi2, conv, n_iter and lambda equal
    to its plain version on every lane; the limit + 1 refused before any
    launch; the wide unit timed at WIDE_TIMED in fp32; then the pileup
    batch with its widest bucket at 24 (WIDE_BUCKETS_24) through
    check_bucket_run, and the path runs of check_path_widths against
    it."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.fit.lm_kernel import (lm_max_pulses, lm_solve_kernel,
                                               lm_solve_plain)
    base = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(base, seed=1)
    K = base.nfitbins
    limits = {dt: lm_max_pulses(K, dt) for dt in (torch.float64, torch.float32)}
    say("k3-wide", f"widest K3 width at K = {K}: fp64 {limits[torch.float64]}, "
                   f"fp32 {limits[torch.float32]} (a lane's arrays in one "
                   f"block's shared memory; {card})")
    equal, timed = {}, {}
    for width, max_pulses in WIDE_WIDTHS:
        for dt in (torch.float64, torch.float32):
            P = limits[dt] if width == "limit" else width
            cfg = base.replace(maxwfpulses=max(P, 15))
            n = WIDE_LANES
            args = list(lm_inputs(torch, cfg, cal, n, max_pulses, P,
                                  91 + P + n, dt, dev))
            if width == "limit":
                args[10] = WIDE_LIMIT_ITERS
            t0 = time.perf_counter()
            k = lm_solve_kernel(cfg, *args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p = lm_solve_plain(cfg, *args)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_eq = lm_equal(torch, k, p)
            its = p[3][args[9]]
            say("k3-wide", f"P={P} {dt} {n} lanes (up to {max_pulses} "
                           f"pulses, at most {args[10]} iterations, "
                           f"{int(p[2].sum())} converged, n_iter "
                           f"{int(its.min())}..{int(its.max())}): u, chi2, "
                           f"conv, n_iter and lambda equal on {n_eq}; "
                           f"first call {(t1 - t0) * 1e3:.1f} ms, plain "
                           f"{(t2 - t1) * 1e3:.1f} ms ({card})")
            check(n_eq == n, f"K3 not bit-equal at P={P} {dt} n={n}")
            equal[f"P={P} {dt} n={n}"] = n_eq
            if width in WIDE_TIMED and dt == torch.float32:
                ms = cuda_ms(torch, lambda: lm_solve_kernel(cfg, *args), 3)
                rec = timed[f"P={P} fp32"] = {
                    "ms": ms, "lanes": n, "max_iter": int(args[10]),
                    **lm_bound(torch, cfg, args, k)}
                say("k3-wide", f"K3 at P={P} fp32, {n} lanes: {ms:.4f} ms a "
                               f"call, plain {(t2 - t1) * 1e3:.1f} ms (one "
                               f"call), bound {rec['bound_ms']:.4f} ms "
                               f"({rec['bound_ms'] / ms:.1%}) ({card})")
            del args, k, p
    for dt, limit in limits.items():
        P = limit + 1
        cfg = base.replace(maxwfpulses=P)
        args = lm_inputs(torch, cfg, cal, 2, 2, P, 5, dt, dev)
        kernels.reset_counts()
        try:
            lm_solve_kernel(cfg, *args)
            refused = False
        except ValueError:
            refused = True
        check(refused and not kernels.launches, f"K3 took P={P} {dt}")
        say("k3-wide", f"P={P} {dt} (the limit + 1) refused before any launch")
    pbase, calib, batch = pileup_batch(torch, dev)
    summary, out24 = check_bucket_run(
        torch, "k3-wide", f"default {WIDE_BUCKETS_24}",
        pbase.replace(**WIDE_BUCKETS_24), calib, batch, (2, 24), "lm_solve",
        card)
    del calib, batch
    t0 = time.perf_counter()
    paths = check_path_widths(torch, dev, card, out24, limits)
    say("k3-wide", f"path runs done in {time.perf_counter() - t0:.1f} s")
    return {"limits": {str(dt): v for dt, v in limits.items()},
            "bit_equal_lanes": equal, "timed": timed,
            "batch_24": dict(changes=WIDE_BUCKETS_24, **summary),
            "paths": paths}


def check_path_widths(torch, dev, card, ref24, limits):
    """The pileup batch through process_batch with its widest bucket at
    each width of WIDE_PATHS (K3's wide unit up to its limit, ``limits``
    by type, on the default route; K6 one lane a block under
    use_fused_system), its
    decisions (wfnpulse, gate, fit_converged, fit_n_iter) against the same
    batch with its widest bucket at 24 on the card, same route and type,
    on every block (bucket routing is result-neutral: pipeline.py's
    widths hold no other lanes, tests/test_torch_pipeline_widths.py); the
    route's kernel launched on every bucket, no plain call. ref24: the
    fp32 default route's width-24 output, already run."""
    summary = {}
    refs = {("default", "float32"): ref24}
    for route, dname, P in WIDE_PATHS:
        dt = getattr(torch, dname)
        P = limits[dt] if P == "limit" else P
        pbase, calib, batch = pileup_batch(torch, dev, dt)
        pbase = pbase.replace(**WIDE_PATH_BUDGETS.get(route, {}))
        kernel = BUCKET_ROUTES[route]
        key = (route, dname)
        if key not in refs:
            cfg = pbase.replace(**WIDE_BUCKETS_24, **ROUTE_FLAGS[route])
            rows, out, ms = run_width(torch, cfg, calib, batch, kernel,
                                      f"{route} {dname} width 24")
            refs[key] = out
            summary[f"{route} {dname} 24"] = {"ms": ms, "buckets": rows}
        bounds = dict(WIDE_BUCKETS_24, maxwfpulses=P, pallas_lm_max_pulses=P)
        cfg = pbase.replace(**bounds, **ROUTE_FLAGS[route])
        rows, out, ms = run_width(torch, cfg, calib, batch, kernel,
                                  f"{route} {dname} width {P}")
        check(any(r["P"] == P and r["lanes"] > 0 for r in rows),
              f"[k3-wide] {route} {dname}: width {P} carried no lanes")
        ref = refs[key]
        diff = {f: int((getattr(out, f) != getattr(ref, f)).sum())
                for f in ("wfnpulse", "gate", "fit_converged", "fit_n_iter")}
        n_fail = int(out.n_fit_failure)
        rate = n_fail / max(int(out.n_fit_success) + n_fail, 1)
        say("k3-wide", f"{route} {dname} widest bucket {P}: {ms:.1f} ms, "
                       f"failure rate {rate:.4%}; against width 24 on the "
                       f"card, values differing {diff} of "
                       f"{out.wfnpulse.numel()} ({card})")
        check(not any(diff.values()), f"[k3-wide] {route} {dname} width "
                                      f"{P} differs from width 24: {diff}")
        summary[f"{route} {dname} {P}"] = {"ms": ms, "failure_rate": rate,
                                           "buckets": rows,
                                           "differ_from_24": diff}
    return summary


def run_width(torch, cfg, calib, batch, kernel, tag):
    """One pileup run through run_buckets: each bucket with lanes solved by
    ``kernel``, no plain call. (bucket rows, output, host ms)."""
    t0 = time.perf_counter()
    out, rows, plain = run_buckets(torch, cfg, calib, batch)
    ms = (time.perf_counter() - t0) * 1e3
    for r in rows:
        say("k3-wide", f"{tag}: P={r['P']}: {r['lanes']} lanes, "
                       f"{r['failed']} failed, launches {r['launches']}")
        check(r["lanes"] == 0 or r["launches"].get(kernel, 0) > 0,
              f"[k3-wide] {tag}: P={r['P']} not solved by {kernel}")
    check(not plain, f"[k3-wide] {tag}: plain versions ran: {plain}")
    return rows, out, ms


# ---------------------------------------------------------------------
# K2 and K4 at wide search settings
# ---------------------------------------------------------------------
def reach_configs(cfg, T, dtype):
    """The configurations at and one past the widest search settings a
    block of 8 lanes takes over T bins (ops.search_kernel.search_layout):
    the widest sigma whose frames a block of 8 lanes holds and the next
    one (found by bisection: the frames grow with sigma), and the widest
    window at cfg's sigma and one more. Past each, the block takes fewer
    lanes. {name: (config, lanes a block)}."""
    from npswf_tpu_torch.ops.search_kernel import search_layout

    def lanes(c):
        return search_layout(c, T, dtype)

    def eight(sigma):
        return lanes(cfg.replace(spec_sigma=sigma)) == 8
    lo, hi = cfg.spec_sigma, 8.0 * cfg.spec_sigma
    while eight(hi):
        lo, hi = hi, 2.0 * hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if eight(mid) else (lo, mid)
    w_lo, w_hi = cfg.spec_aver_window, 2 * cfg.spec_aver_window
    while lanes(cfg.replace(spec_aver_window=w_hi)) == 8:
        w_lo, w_hi = w_hi, 2 * w_hi
    while w_hi - w_lo > 1:
        mid = (w_lo + w_hi) // 2
        if lanes(cfg.replace(spec_aver_window=mid)) == 8:
            w_lo = mid
        else:
            w_hi = mid
    out = {"lag limit": cfg.replace(spec_sigma=lo),
           "lag limit + 1": cfg.replace(spec_sigma=hi),
           "window limit": cfg.replace(spec_aver_window=w_lo),
           "window limit + 1": cfg.replace(spec_aver_window=w_hi)}
    return {name: (c, lanes(c)) for name, c in out.items()}


def setting(cfg, T):
    """sigma, lh_gold - 1 and window of a configuration, for the log."""
    from npswf_tpu_torch.ops.peak_search import search_geometry
    return (f"sigma={cfg.spec_sigma:.6g} (lh_gold-1 = "
            f"{search_geometry(cfg, T)[4] - 1}), window={cfg.spec_aver_window}")


def search_pair_equal(torch, cfg, s, a, P):
    """K2 (P = 0) or K4 against its plain version: values differing on
    each of the four outputs (a NaN matching a NaN), and the outputs."""
    from npswf_tpu_torch.ops.peak_search import search_operands, search_topk
    from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                                   search_topk_kernel)
    if P:
        k = search_topk_kernel(cfg, s, a, -1, P)
        p = search_topk(cfg, s, a, -1, P)
    else:
        k = search_operands_kernel(cfg, s, a, -1)
        p = search_operands(cfg, s, a, -1)
    torch.cuda.synchronize()
    return [n_unequal(torch, x, y) for x, y in zip(k, p)], k, p


def time_search(torch, cfg, s, a, P):
    """K2 (P = 0) or K4 at fp32: wrapper ms (CUDA events), the kernel
    alone (profiler), plain ms and the bound."""
    from npswf_tpu_torch.ops.peak_search import search_operands, search_topk
    from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                                   search_topk_kernel)
    N, T = s.shape
    if P:
        fn = lambda: search_topk_kernel(cfg, s, a, -1, P)  # noqa: E731
        plain = lambda: search_topk(cfg, s, a, -1, P)  # noqa: E731
        out_bytes = 4 * N * P * s.element_size()
    else:
        fn = lambda: search_operands_kernel(cfg, s, a, -1)  # noqa: E731
        plain = lambda: search_operands(cfg, s, a, -1)  # noqa: E731
        out_bytes = 4 * nbytes(s)
    # repetitions: 10, fewer where a call takes tens of ms (the widest
    # windows and reaches take 30-450 ms a call)
    first = cuda_ms(torch, fn, 1)
    reps = int(min(10, max(2, 100.0 / max(first, 1e-3))))
    return {"ms": cuda_ms(torch, fn, reps),
            "kernel_ms": kernel_ms(torch, fn, reps, "search_kernel"),
            "plain_ms": cuda_ms(torch, plain, 1 if reps < 10 else 2),
            "reps": reps,
            **bound(nbytes(s, a) + out_bytes, ops_search(cfg, N, T, P))}


def check_search_wide(torch, cfg, cal, calib, truth, batch, dev, card):
    """The [search-wide] phase. On the dense batch's lanes (the
    fp32-quantized filter output, the raw signal), K2 and K4 (P =
    maxwfpulses) at SEARCH_WIDE and at and one past the widest settings a
    block of 8 lanes takes (reach_configs, on the first REACH_LANES
    lanes), fp32 and fp64, every output bit-equal to the plain version's,
    with the lanes a block each takes; timed at fp32 (K2 and K4 at
    SEARCH_TIMED_BOTH, K2 alone past them). Then process_batch at
    SEARCH_WIDE_BATCHES on the default route (K1, K2, K3) and the slice
    route (K1, K4, K5), no plain call, and wfnpulse, gate, fit_converged
    and fit_n_iter equal to the plain path's at the same setting on every
    block; then every SearchHighRes fixture (tests/data) through K2 and
    K4."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
    from npswf_tpu_torch.engine.pipeline import process_batch
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.ops.peak_search import tspectrum_search
    from npswf_tpu_torch.ops.search_kernel import search_layout
    lanes = mf_lanes(torch, cal, truth.signal, dev)
    src = matched_filter(cfg, *lanes).to(torch.float32).to(torch.float64)
    aux = lanes[0]
    del lanes
    N, T = src.shape
    P = cfg.maxwfpulses
    summary = {"reach": {}, "cases": {}, "timed": {}}
    for dt in (torch.float64, torch.float32):
        s, a = src.to(dt), aux.to(dt)
        reach = reach_configs(cfg, T, dt)
        summary["reach"][str(dt)] = {
            name: {"setting": setting(c, T), "lanes": n}
            for name, (c, n) in reach.items()}
        say("search-wide", f"{dt} at T = {T}: a block of 8 lanes takes up to "
                           f"{setting(reach['lag limit'][0], T)} and "
                           f"{setting(reach['window limit'][0], T)}; past "
                           f"them {reach['lag limit + 1'][1]} and "
                           f"{reach['window limit + 1'][1]} lanes ({card})")
        cases = [(f"sigma={sg} window={w}",
                  cfg.replace(spec_sigma=sg, spec_aver_window=w))
                 for sg, w in SEARCH_WIDE]
        cases += [(name, c) for name, (c, _) in reach.items()]
        for name, c in cases:
            n_lanes = search_layout(c, T, dt)
            # the edges of a layout: its first REACH_LANES lanes (the
            # plain version takes 0.7-2.4 s on all of them there)
            rows = slice(None) if name not in reach else slice(0, REACH_LANES)
            for kname, p in (("K2", 0), ("K4", P)):
                ndiff, k, pl = search_pair_equal(torch, c, s[rows], a[rows], p)
                n_acc = int(torch.isfinite(pl[0]).sum())
                say("search-wide", f"{kname} {dt} {setting(c, T)} "
                                   f"({n_lanes} lanes a block): {n_acc} "
                                   f"accepted; values differing bitwise "
                                   f"(negkey, cent, pos_y, aux) {ndiff}")
                check(n_acc > 0, f"[search-wide] no peak accepted at {name}")
                check(sum(ndiff) == 0, f"[search-wide] {kname} not bit-equal "
                                       f"at {name} {dt}")
                summary["cases"][f"{kname} {name} {dt}"] = {
                    "setting": setting(c, T), "accepted": n_acc,
                    "lanes_a_block": n_lanes,
                    "max_abs_err": max_abs_diff(torch, zip(k, pl))}
                del k, pl
                both = any(name == f"sigma={sg} window={w}"
                           for sg, w in SEARCH_TIMED_BOTH)
                # the reach's edges (8,640 lanes) are held, not timed
                if (dt == torch.float32 and name not in reach
                        and (both or kname == "K2")):
                    rec = summary["timed"][f"{kname} {name}"] = dict(
                        time_search(torch, c, s, a, p), lanes_a_block=n_lanes)
                    say("search-wide", f"{kname} fp32 {setting(c, T)}: "
                                       f"{rec['ms']:.4f} ms (kernel "
                                       f"{rec['kernel_ms']}), plain "
                                       f"{rec['plain_ms']:.4f} ms, bound "
                                       f"{rec['bound_ms']:.4f} ms "
                                       f"({rec['bound_by']}) ({card})")
        del s, a
    del src, aux

    E, B, _ = batch.signal.shape
    corr = np.random.default_rng(11).uniform(-2, 2, E).astype(np.float32)
    summary["batch"] = {}
    for changes, dname in SEARCH_WIDE_BATCHES:
        dt = getattr(torch, dname)
        wide = cfg.replace(**changes)
        if dt == torch.float32:
            b, cb = batch, calib
        else:
            b = batch_to_torch(truth.signal.astype(np.float32), truth.pres,
                               corr, dev, dt)
            cb = calib_to_torch(cal.device_arrays(
                cfg.replace(compute_dtype=dname)), dev, dt)
        for route in ("default", "slice"):
            rc = wide.replace(**ROUTE_FLAGS[route])
            must, zero = ROUTES[route]
            kernels.reset_counts()
            t0 = time.perf_counter()
            out = process_batch(rc, cb, b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches, plain = dict(kernels.launches), dict(kernels.plain_calls)
            ref = process_batch(rc, cb, b, plain=True)
            diff = {f: int((getattr(out, f) != getattr(ref, f)).sum())
                    for f in ("wfnpulse", "gate", "fit_converged",
                              "fit_n_iter")}
            n_fail = int(out.n_fit_failure)
            rate = n_fail / max(int(out.n_fit_success) + n_fail, 1)
            say("search-wide", f"{route} {dname} at {changes}: first call "
                               f"{ms:.1f} ms, pulses {int(out.wfnpulse.sum())}, "
                               f"failure rate {rate:.4%} ({n_fail} fits); "
                               f"launches {launches}; plain calls {plain}; "
                               f"against the plain path, values differing "
                               f"{diff} of {E * B} ({card})")
            for name in must:
                check(launches.get(name, 0) > 0,
                      f"[search-wide] {route}: kernel {name} not launched")
            for name in zero:
                check(launches.get(name, 0) == 0,
                      f"[search-wide] {route}: kernel {name} launched")
            check(not plain, f"[search-wide] {route}: plain versions ran")
            check(not any(diff.values()),
                  f"[search-wide] {route} {changes}: differs from the plain "
                  f"path: {diff}")
            for f, v in out._asdict().items():
                if v.is_floating_point():
                    check(bool(torch.isfinite(v).all()),
                          f"[search-wide] {route}: {f} not finite")
            med = (float(np.median([timed_batch(torch, rc, cb, b)
                                    for _ in range(3)]))
                   if dt == torch.float32 else None)
            summary["batch"][f"{route} {dname} {changes}"] = {
                "ms": med, "first_ms": ms, "failure_rate": rate,
                "pulses": int(out.wfnpulse.sum()), "launches": launches,
                "differ": diff}
            del out, ref

    with open(os.path.join(REPO, "tests", "data",
                           "searchhighres_fixtures.json")) as f:
        fixtures = json.load(f)["fixtures"]
    for select, kname in ((False, "search_operands"), (True, "search_topk")):
        for fx in fixtures:
            c = cfg.replace(spec_sigma=fx["sigma"],
                            specthres=fx["threshold_frac"],
                            maxwfpulses=fx["max_peaks"],
                            spec_decon_iterations=fx["decon_iterations"],
                            spec_aver_window=fx["aver_window"],
                            pallas_search_select=select)
            s = torch.as_tensor(np.asarray(fx["source"], np.float64),
                                device=dev)[None, :]
            kernels.reset_counts()
            px, py, valid = tspectrum_search(c, s)
            v = valid[0].cpu().numpy()
            got = (list(px[0].cpu().numpy()[v]), list(py[0].cpu().numpy()[v]))
            check(kernels.launches.get(kname, 0) == 1
                  and not kernels.plain_calls,
                  f"[search-wide] fixture {fx['name']} not through {kname}")
            check(got == (fx["expected_pos_x"], fx["expected_pos_y"]),
                  f"[search-wide] fixture {fx['name']} through {kname}: "
                  f"{got}")
        say("search-wide", f"{len(fixtures)} SearchHighRes fixtures (with "
                           f"prod_sigma3_threshold5) reproduced through "
                           f"{kname}")
    summary["fixtures"] = len(fixtures)
    return summary


def timed_batch(torch, cfg, calib, batch):
    """Host clock around one synchronized process_batch, in ms."""
    from npswf_tpu_torch.engine.pipeline import process_batch
    t0 = time.perf_counter()
    process_batch(cfg, calib, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def host_cpu():
    """The host's name, CPU model and core count (for host-clock numbers)."""
    import platform
    name = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"host {platform.node()}, {name}, {os.cpu_count()} cores"


def check_tools(torch, dev, card, dense_wf):
    """The [tools] phase, through the CLI in subprocesses: parity of the
    dense [segment] WF file against itself (exit 0) and against a copy with
    every wftime 0.2 bins later (exit 1); extract-templates on a dense
    single-pulse segment, then run on the card with that calibration;
    solver-audit on the card; cpu-baseline (host numbers). The audit's fit
    also runs in process, its launches counted (K1, K2, K3, no plain
    call)."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.tools.solver_audit import audit_signal
    from npswf_tpu_torch.utils.synthetic import make_events
    cfg = NPSConfig()
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        shifted = os.path.join(tmp, "shifted.npz")
        with np.load(dense_wf, allow_pickle=False) as z:
            cols = dict(z)
        cols["wftime_flat"] = cols["wftime_flat"] + 0.2 * cfg.dt
        np.savez(shifted, **cols)
        cli_call("tools", "parity", "--ref", dense_wf, "--ours", dense_wf)
        cli_call("tools", "parity", "--ref", dense_wf, "--ours", shifted,
                 expect=1)
        say("tools", "parity: the dense segment's WF file passes against "
                     "itself and fails with wftime 0.2 bins later")

        seg, cal, calx, wf = (os.path.join(tmp, n) for n in
                              ("seg.npz", "cal.npz", "calx.npz", "wf.npz"))
        cli_call("tools", "synth", "--events", str(EXTRACT_EVENTS),
                 "--occupancy", "1.0", "--max-pulses", "1", "--out", seg,
                 "--calib-out", cal)
        ext = cli_call("tools", "extract-templates", "--", seg, calx)
        n_ext = int(ext.split("extracted templates for ")[1].split("/")[0])
        n_fail, n_succ = fit_totals(cli_call("tools", "run", "--input", seg,
                                             "--calib", calx, "--out", wf))
        rate = n_fail / max(n_fail + n_succ, 1)
        say("tools", f"extract-templates: {n_ext} of {cfg.nblocks} blocks "
                     f"from {EXTRACT_EVENTS} events; run on the card with "
                     f"them: {n_succ} fits ok, {n_fail} failed ({rate:.4%}) "
                     f"({card})")
        check(n_ext > 1000, f"[tools] only {n_ext} blocks extracted")
        check(rate < FAIL_RATE_MAX, f"[tools] failure rate {rate:.4%} with "
                                    f"the extracted calibration")
        summary["extract_templates"] = {"blocks": n_ext, "fits_ok": n_succ,
                                        "fits_failed": n_fail,
                                        "failure_rate": rate}

        acal = synthetic_calibration(cfg, seed=1)
        truth = make_events(cfg, acal, AUDIT_EVENTS, occupancy=1.0,
                            max_pulses=2, pileup_prob=0.25, seed=7)
        kernels.reset_counts()
        row = audit_signal(cfg, acal, truth.signal, truth.pres, sample=20,
                           device=dev)
        torch.cuda.synchronize()
        launches, plain = dict(kernels.launches), dict(kernels.plain_calls)
        say("tools", f"solver audit in process, clean ensemble: {row}; "
                     f"launches {launches}")
        for name in ("matched_filter", "search_operands", "lm_solve"):
            check(launches.get(name, 0) > 0, f"[tools] audit: {name} not "
                                             f"launched")
        check(not plain, f"[tools] audit: plain versions ran: {plain}")
        out = cli_call("tools", "solver-audit", "--", "--events",
                       str(AUDIT_EVENTS), "--sample", "20")
        table = json.loads(out.strip().splitlines()[-1])
        for name, r in table.items():
            say("tools", f"solver-audit {name}: {r['n_fits']} fits, "
                         f"{r['n_failed']} failed, {r['n_audited']} audited: "
                         f"lm_stuck {r['lm_stuck']}, same_minimum "
                         f"{r['same_minimum']}, lm_better {r['lm_better']}")
        check(set(table) == {"clean", "wrong_shape", "correlated_noise",
                             "clipped"}, "[tools] solver-audit ensembles")
        summary["solver_audit"] = {"in_process_launches": launches,
                                   "table": table}

        base = json.loads(cli_call("tools", "cpu-baseline", "--",
                                   "--time-budget-s", "1", "--min-blocks",
                                   "8"))
        cpu = host_cpu()
        bps = base["blocks_per_sec_4thread"]
        say("tools", f"cpu-baseline: {bps['median']:.1f} blocks/s "
                     f"(4 threads, median of seeds; min {bps['min']:.1f}, "
                     f"max {bps['max']:.1f}) on the host CPU ({cpu}), "
                     f"not a card number")
        summary["cpu_baseline"] = {"blocks_per_sec_4thread": bps,
                                   "host_cpu": cpu}
    return summary


# ---------------------------------------------------------------------
# the mesh and the probes
# ---------------------------------------------------------------------
def check_mesh(torch, card, dense_wf):
    """The [mesh] phase: the mesh's dry run (parallel.dryrun.dryrun) of the
    dense bench batch over a world of one rank on NCCL and over gloo ranks
    sharing cuda:0 (MESH_SHAPES), each against process_batch on the card:
    every per-block field and counter equal, value for value (every
    kernel works per lane), enertot/integtot within the rounding of their
    sum over the blocks (the card's row reduction picks its order by the
    shard's event count), and K1, K2 and K3
    launched on every rank with no plain call; then the dense segment
    through run_segment under MESH_SEGMENT_SHAPE, its WF file equal to the
    single-device file ``dense_wf`` of [segment]. Four ranks on one card
    share it: their times are no scaling figure."""
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.io.writer import read_wf
    from npswf_tpu_torch.parallel.dryrun import dryrun
    from npswf_tpu_torch.parallel.mesh import make_mesh
    from npswf_tpu_torch.runtime.executor import run_segment
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    _, batch = bench_batch(torch, cfg, cal, torch.device("cpu"))
    meshes = [("nccl", 1, 1)] + [("gloo", nd, nb) for nd, nb in MESH_SHAPES]
    try:
        summary = dryrun(cfg, cal, batch, meshes, ["cuda:0"] * 4)
    except AssertionError as e:
        raise SmokeFailure(f"[mesh] {e}")
    for tag, m in summary["meshes"].items():
        say("mesh", f"{tag}: {len(m['launches'])} ranks on cuda:0, the dense "
                    f"batch (E={E_BENCH}) in {m['seconds_with_start']:.1f} s "
                    f"with the ranks' start (the {len(meshes)} meshes at "
                    f"once); every per-block field and counter equal to "
                    f"process_batch on the card, the event totals within "
                    f"{m['totals_max_diff']:.3g}; launches a rank "
                    f"{m['launches']}; counters "
                    f"{summary['fit_success']} ok, {summary['fit_failures']} "
                    f"failed ({card})")
    seg = build_segment_in_memory("dense")
    nd, nb = MESH_SEGMENT_SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh.npz")
        t0 = time.perf_counter()
        # check_segments' configuration and calibration
        res = run_segment(NPSConfig(), synthetic_calibration(NPSConfig(), seed=1),
                          seg, out, batch_size=SEG_BATCH,
                          mesh=make_mesh(cfg, nd, nb,
                                         devices=["cuda:0"] * (nd * nb),
                                         backend="gloo"))
        wall = time.perf_counter() - t0
        a, b = read_wf(out), read_wf(dense_wf)
        differ = [k for k in b if k not in a or not np.array_equal(a[k], b[k])
                  or a[k].dtype != b[k].dtype]
        with open(out, "rb") as f1, open(dense_wf, "rb") as f2:
            same_bytes = f1.read() == f2.read()
    say("mesh", f"run_segment on {seg.n_events} dense events under "
                f"{nd}x{nb} gloo ranks sharing cuda:0: {res.blocks_per_sec:.0f} "
                f"blocks/s on rank 0's clock ({res.wall_time:.3f} s; "
                f"{wall:.1f} s with the ranks' start), fits ok "
                f"{res.n_fit_success}, failed {res.n_fit_failure}; columns "
                f"differing from the single-device file: {differ}; bytes "
                f"equal: {same_bytes}. Four ranks on one card are no scaling "
                f"figure ({card})")
    check(not differ, f"[mesh] the mesh's WF file differs in {differ}")
    summary["segment"] = {"shape": [nd, nb], "events": seg.n_events,
                          "blocks_per_s": res.blocks_per_sec,
                          "wall_s": res.wall_time, "wall_with_start_s": wall,
                          "bytes_equal": same_bytes, "card": card}
    return summary


PROBE_CALLS = {   # the four probes at small settings, through the CLI
    "measure-link": ("measure-link", "--", "--n", "9", "--size-mb", "64"),
    "perf-probe floor": ("perf-probe", "--", "floor", "--events", "64",
                         "--iters", "4", "--chain", "1"),
    "e2e-bench": ("e2e-bench", "--", "--events", "256", "--mode", "both",
                  "--chain-batches", "4"),
    "glue-profile": ("glue-profile", "--", "--events", "64", "--k1", "1",
                     "--k2", "4", "--iters", "2"),
}


def check_probes(card):
    """The [probes] phase: each probe through the CLI in a subprocess on
    the card; each exits 0 and its last line is JSON."""
    summary = {}
    for name, argv in PROBE_CALLS.items():
        t0 = time.perf_counter()
        out = cli_call("probes", *argv)
        try:
            summary[name] = json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            raise SmokeFailure(f"[probes] {name} printed no JSON last line")
        summary[name + " seconds"] = time.perf_counter() - t0
    link = summary["measure-link"]
    floor = summary["perf-probe floor"]
    say("probes", f"measure-link: H2D {link['h2d']['median_GBps']:.3f} GB/s, "
                  f"D2H {link['d2h']['median_GBps']:.3f} GB/s (pinned, 64 MB, "
                  f"median of 9); dense 64-event batch transfer floor "
                  f"{link['dense_batch']['transfer_floor_ms']:.3f} ms ({card})")
    say("probes", "perf-probe floor: " + ", ".join(
        f"{k} {v:.4f}" for k, v in floor.items() if k != "probe")
        + f" ({card})")
    say("probes", "e2e-bench: " + "; ".join(
        f"{r['mode']} {r['e2e_blocks_per_sec']:.0f} blocks/s end to end, "
        f"device-only {r['device_blocks_per_sec']:.0f}" for r in
        summary["e2e-bench"]) + f" ({card})")
    glue = summary["glue-profile"]
    say("probes", "glue-profile ms a batch: " + ", ".join(
        f"{k} {glue[k]:.3f}" for k in ("full", "fit", "search", "diag",
                                       "glue_direct", "fit_stage3",
                                       "fit_stage2")) + f" ({card})")
    return summary


def time_systems(torch, card):
    """K2 and K4 (P = 12) at the default search settings, K6 at P = 2 and
    12 and K7 at P = 2, fp32, N = 69,120, as a wrapper call (CUDA events)
    and as the kernel alone (the profiler's device time), and K3's wide
    unit at P = 24 fp32 on 4,096 lanes (a wrapper call), for whichever
    package the path finds first: run it once for each of two checkouts,
    in turns, to compare them on one card."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.fit.eval_kernel import fused_neq, fused_system
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                                   search_topk_kernel)
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    kernels.library()
    n = cal.nblocks * E_BENCH
    res = {}
    dev = torch.device("cuda", 0)
    truth, _ = bench_batch(torch, cfg, cal, dev)
    lanes = mf_lanes(torch, cal, truth.signal, dev)
    # check_search's inputs: the filter output quantized to fp32, the signal
    s = matched_filter(cfg, *lanes).to(torch.float32)
    a = lanes[0].to(torch.float32)
    P = cfg.maxwfpulses
    for name, fn in (("search_operands", lambda: search_operands_kernel(cfg, s, a, -1)),
                     (f"search_topk P={P}",
                      lambda: search_topk_kernel(cfg, s, a, -1, P))):
        res[name] = {"ms": cuda_ms(torch, fn, 20),
                     "kernel_ms": kernel_ms(torch, fn, 20, "search_kernel")}
    del truth, lanes, s, a
    for P, max_pulses in ((2, 2), (12, 6)):
        sys_args, neq_args = system_inputs(torch, cfg, cal, n, P, max_pulses,
                                           41 + P, torch.float32,
                                           torch.device("cuda", 0))
        calls = [("fused_system", "system_kernel",
                  lambda: fused_system(cfg, *sys_args))]
        if neq_args is not None:
            calls.append(("fused_neq", "neq_kernel",
                          lambda: fused_neq(cfg, *neq_args)))
        for name, kname, fn in calls:
            res[f"{name} P={P}"] = {"ms": cuda_ms(torch, fn, 20),
                                    "kernel_ms": kernel_ms(torch, fn, 20, kname)}
    res["lm_solve wide P=24"] = time_wide(torch, cfg, cal, 24, WIDE_LANES)
    print(json.dumps({"time_systems": res, "package": kernels.__file__,
                      "card": card}))
    return 0


def time_wide(torch, cfg, cal, P, n, reps=5):
    """K3's wide unit at P pulses, fp32, on [k3-wide]'s n lanes: a
    wrapper call (CUDA events, mean of reps) beside its bound."""
    from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel
    cfg = cfg.replace(maxwfpulses=max(P, 15))
    args = lm_inputs(torch, cfg, cal, n, 8, P, 91 + P + n, torch.float32,
                     torch.device("cuda", 0))
    out = lm_solve_kernel(cfg, *args)
    ms = cuda_ms(torch, lambda: lm_solve_kernel(cfg, *args), reps)
    return {"ms": ms, "lanes": n, **lm_bound(torch, cfg, args, out)}


def time_route(torch, card):
    """The default route's process_batch on the dense bench batch, fp32:
    host clock around one synchronized batch, each of 21 after 3 warm-ups,
    for whichever package the path finds first: run it once for each of
    two checkouts, in turns, to compare them on one card."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.engine.pipeline import process_batch
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    dev = torch.device("cuda", 0)
    kernels.library()
    _, batch = bench_batch(torch, cfg, cal, dev)
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float32)

    def one():
        t0 = time.perf_counter()
        process_batch(cfg, calib, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    for _ in range(3):
        one()
    ms = [one() for _ in range(21)]
    print(json.dumps({"time_route": {"median_ms": float(np.median(ms)),
                                     "min_ms": min(ms), "ms": ms},
                      "package": kernels.__file__, "card": card}))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "npswf_tpu_torch")):
        print("chip_smoke: run it from the repository (npswf_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    timers = {"--time-systems": time_systems, "--time-route": time_route}
    if sys.argv[1:2] and sys.argv[1] in timers:
        # python3 chip_smoke.py --time-systems|--time-route ROOT: the
        # package of the checkout at ROOT (built there)
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        return timers[sys.argv[1]](torch, card_line())
    sys.path.insert(0, REPO)
    try:
        return run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1


def run(torch) -> int:
    t_start = time.perf_counter()
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.ops.matched_filter import matched_filter

    # ---- 1. device ----------------------------------------------------
    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
                  f"torch {torch.__version__} CUDA {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    say("build", f"{kernels.library_path().name} ready in "
                 f"{time.perf_counter() - t0:.1f} s (nvcc sm_90a, one process "
                 f"a source)")

    records = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep} for name, (src, rep) in KERNELS.items()}

    # ---- 3. kernels against their plain versions ------------------------
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    t0 = time.perf_counter()
    truth, batch = bench_batch(torch, cfg, cal, dev)
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float32)
    E, B, T = batch.signal.shape
    say("data", f"bench batch E={E} B={B} T={T} built in "
                f"{time.perf_counter() - t0:.1f} s")
    lanes = mf_lanes(torch, cal, truth.signal, dev)
    check_matched_filter(torch, cfg, lanes, records)
    mf32 = matched_filter(cfg, *lanes).to(torch.float32).to(torch.float64)
    check_search(torch, cfg, mf32, lanes[0], records)
    check_search_topk(torch, cfg, mf32, lanes[0], records)
    del lanes, mf32
    check_lm(torch, cfg, cal, dev, records)
    check_lm_retry(torch, cfg, cal, dev)
    check_lm_ladder(torch, cfg, cal, dev, records, card)
    check_fused_eval(torch, cfg, cal, dev, records)
    check_systems(torch, cfg, cal, dev, records, card)
    for route, flags in ROUTE_FLAGS.items():
        n_conv = small_reference(torch, dev, flags)
        say("reference", f"{route}: small fp64 batch, decisions equal to the "
                         f"plain path ({n_conv} converged fits)")

    # ---- 4./5. the routes of the main path, their checks and times -----
    default_out = None
    route_launches, route_ms = {}, {}
    for route in ROUTES:
        out, route_launches[route], route_ms[route] = run_route(
            torch, cfg.replace(**ROUTE_FLAGS[route]), calib, truth, batch,
            route, card, default_out)
        if default_out is None:
            default_out = out
    for name, route in LAUNCHES_FROM.items():
        records[name]["launches"] = route_launches[route].get(name, 0)
    time_lm_launches(torch, cfg, calib, batch, records, card)
    del default_out, out
    t0 = time.perf_counter()
    graph = check_graph(torch, dev, card)
    say("graph", f"phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    search_wide = check_search_wide(torch, cfg, cal, calib, truth, batch,
                                    dev, card)
    say("search-wide", f"phase done in {time.perf_counter() - t0:.1f} s")
    del truth
    t0 = time.perf_counter()
    models = check_models(torch, cfg, cal, calib, batch, dev, card)
    say("models", f"phase done in {time.perf_counter() - t0:.1f} s")
    del batch
    t0 = time.perf_counter()
    buckets = check_buckets(torch, dev, card)
    say("buckets", f"phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k3_wide = check_k3_wide(torch, dev, card)
    say("k3-wide", f"phase done in {time.perf_counter() - t0:.1f} s")

    # ---- 6. the segment executor, the CLI and the tools ------------------
    with tempfile.TemporaryDirectory() as wf_dir:
        segment = check_segments(torch, dev, card, route_ms["default"],
                                 records, wf_dir)
        check_cli(card)
        t0 = time.perf_counter()
        tools = check_tools(torch, dev, card,
                            os.path.join(wf_dir, "dense_1.npz"))
        say("tools", f"phase done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh = check_mesh(torch, card, os.path.join(wf_dir, "dense_1.npz"))
        say("mesh", f"phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probes = check_probes(card)
    say("probes", f"phase done in {time.perf_counter() - t0:.1f} s")

    # ---- 7. records -----------------------------------------------------
    for r in records.values():
        for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"):
            check(key in r, f"{r['name']}: {key} not measured")
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        say("times", f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
                     f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                     f"({r['bound_by']}){lib}; {r['launches']} launches on "
                     f"its route ({card})")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"graph": graph}))
    print(json.dumps({"segment": segment}))
    print(json.dumps({"buckets": buckets}))
    print(json.dumps({"models": models}))
    print(json.dumps({"k3_wide": k3_wide}))
    print(json.dumps({"search_wide": search_wide}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"probes": probes}))
    say("done", f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

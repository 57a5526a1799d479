#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``npswf_tpu_torch/csrc`` with nvcc
(one nvcc per source, all started together), holds each of the seven
kernels against its plain PyTorch version on the card at the main path's
shapes, and drives ``process_batch`` on the dense 64-event batch of the
full 1080-block calorimeter along four routes: the default path (K1, K2,
K3), the generic LM loop with the in-kernel top-P search (K1, K4, K5) and
its two system variants (K5 + K7, and K6). Each route's launch counts are
read from its own run, its result is checked, and it is timed against the
plain path. It prints one JSON line of kernel records (times, launches,
bounds), the card's name and power limit, and a last JSON line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero. It
imports no jax. Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's dense batch: E events x 1080 blocks x 110 samples, fp32
E_BENCH = 64
FAIL_RATE_MAX = 0.02
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
    "lm_solve": ("npswf_tpu_torch/csrc/lm.cu",
                 "npswf_tpu/fit/pallas_lm.py:122"),
    "fused_eval": ("npswf_tpu_torch/csrc/eval.cu",
                   "npswf_tpu/fit/pallas_eval.py:64"),
    "fused_neq": ("npswf_tpu_torch/csrc/eval.cu",
                  "npswf_tpu/fit/pallas_eval.py:314"),
    "fused_system": ("npswf_tpu_torch/csrc/eval.cu",
                     "npswf_tpu/fit/pallas_eval.py:171"),
}
# the routes of process_batch (flags in npswf_tpu_torch/trace.py): kernels
# that must launch, kernels that must not
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


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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


# ---------------------------------------------------------------------
# phases: each kernel against its plain version
# ---------------------------------------------------------------------
def check_matched_filter(torch, cfg, lanes, records):
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.ops.mf_kernel import matched_filter_kernel
    for dt in (torch.float64, torch.float32):
        args = [a.to(dt) for a in lanes]
        k = matched_filter_kernel(cfg, *args)
        p = matched_filter(cfg, *args)
        torch.cuda.synchronize()
        ndiff = int((k != p).sum())
        err = float((k - p).abs().max())
        say("K1", f"{dt}: {ndiff} of {k.numel()} values differ (bitwise), "
                  f"max|d| {err:.3e}")
        check(ndiff == 0, f"matched filter not bit-equal at {dt}")
    args = [a.to(torch.float32) for a in lanes]
    N, T = args[0].shape
    records["matched_filter"].update(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: matched_filter_kernel(cfg, *args), 20),
        plain_ms=cuda_ms(torch, lambda: matched_filter(cfg, *args), 20),
        library_ms=None,
        **bound(nbytes(*args, k.to(torch.float32)),
                N * T * (4 * cfg.mfwidth + 2)))


def check_search(torch, cfg, src, aux, records):
    """src: the fp32-quantized filter output; aux: the raw signal."""
    from npswf_tpu_torch.ops.peak_search import search_operands
    from npswf_tpu_torch.ops.search_kernel import search_operands_kernel
    N, T = src.shape
    for dt in (torch.float64, torch.float32):
        s, a = src.to(dt), aux.to(dt)
        k = search_operands_kernel(cfg, s, a, -1)
        p = search_operands(cfg, s, a, -1)
        torch.cuda.synchronize()
        acc_k, acc_p = torch.isfinite(k[0]), torch.isfinite(p[0])
        lanes_diff = int((acc_k != acc_p).any(dim=1).sum())
        both = acc_k & acc_p
        n_acc = int(acc_p.sum())
        cent_err = float((k[1] - p[1])[both].abs().max()) if n_acc else 0.0
        rel = lambda i: float(((k[i] - p[i]).abs()          # noqa: E731
                               / p[i].abs().clamp(min=1e-30))[both].max()) if n_acc else 0.0
        say("K2", f"{dt}: {n_acc} accepted bins, accept masks differ on "
                  f"{lanes_diff} of {N} lanes; on bins accepted by both: "
                  f"max|dcent| {cent_err:.3e}, max rel dcent {rel(1):.3e}, "
                  f"max rel dpos_y {rel(2):.3e}, max rel daux {rel(3):.3e}")
        check(n_acc > N, "too few accepted peaks for a meaningful check")
        if dt == torch.float64:
            # fp64: decisions identical, values to 1e-9 relative
            check(lanes_diff == 0, "fp64 accept masks differ")
            check(max(rel(1), rel(2), rel(3)) <= 1e-9, "fp64 operands differ")
        else:
            # fp32: both sum in one order, so they should agree exactly; the
            # band admits a few marginal local-max flips should the card's
            # transcendentals differ from PyTorch's, and centroids to 1e-3
            # bins (50x under the 0.05-bin parity bar)
            check(lanes_diff <= max(2, N // 10000), "fp32 accept masks differ")
            check(cent_err <= 1e-3, "fp32 centroids differ")
            records["search_operands"]["max_abs_err"] = cent_err
    s, a = src.to(torch.float32), aux.to(torch.float32)
    records["search_operands"].update(
        ms=cuda_ms(torch, lambda: search_operands_kernel(cfg, s, a, -1), 5),
        plain_ms=cuda_ms(torch, lambda: search_operands(cfg, s, a, -1), 3),
        library_ms=None,
        **bound(nbytes(s, a) + 4 * nbytes(s), ops_search(cfg, N, T)))


def check_search_topk(torch, cfg, src, aux, records):
    """K4 against the plain search_topk: valid slots equal, negkey, cent,
    pos_y and aux bit-equal on them, at both types."""
    from npswf_tpu_torch.ops.peak_search import search_topk
    from npswf_tpu_torch.ops.search_kernel import search_topk_kernel
    N, T = src.shape
    P = cfg.maxwfpulses
    for dt in (torch.float64, torch.float32):
        s, a = src.to(dt), aux.to(dt)
        k = search_topk_kernel(cfg, s, a, -1, P)
        p = search_topk(cfg, s, a, -1, P)
        torch.cuda.synchronize()
        vk, vp = k[0] < float("inf"), p[0] < float("inf")
        n_valid = int(vp.sum())
        slot_diff = int((vk != vp).sum())
        ndiff = [int((x[vp] != y[vp]).sum()) for x, y in zip(k, p)]
        err = max(float((x[vp] - y[vp]).abs().max()) for x, y in zip(k[1:], p[1:]))
        say("K4", f"{dt}: {n_valid} valid slots of {N * P}; validity differs "
                  f"on {slot_diff}; values differing bitwise on valid slots "
                  f"(negkey, cent, pos_y, aux) {ndiff}")
        check(n_valid > N, "too few valid slots for a meaningful check")
        check(slot_diff == 0 and sum(ndiff) == 0,
              f"search_topk not bit-equal at {dt}")
    s, a = src.to(torch.float32), aux.to(torch.float32)
    records["search_topk"].update(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: search_topk_kernel(cfg, s, a, -1, P), 5),
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
            say("K3", f"P={P} {dt}: {n} lanes, {n_conv} converged; conv "
                      f"flips {conv_flip}, n_iter flips {traj_flip}; u "
                      f"bit-equal on {n_bit} lanes; on same-trajectory lanes "
                      f"max|du| {du:.3e}, max rel dchi2 {dchi:.3e}")
            check(n_conv > n // 2, "too few converged lanes")
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
                    M = 1 + 2 * P
                    K = args[2].shape[1]
                    it = it_k[args[9]].to(torch.float64)
                    nops = float(((it + 1) * ops_system(K, P)
                                  + it * (M ** 3 + 4 * M * M + 10 * M)).sum())
                    ins = [a for a in args if isinstance(a, torch.Tensor)]
                    records["lm_solve"]["max_abs_err"] = du
                    records["lm_solve"].update(
                        ms=cuda_ms(torch, lambda: lm_solve_kernel(cfg, *args), 3),
                        plain_ms=cuda_ms(torch, lambda: lm_solve_plain(cfg, *args), 1),
                        library_ms=None,
                        **bound(nbytes(*ins, *k), nops))
            del args, k, p


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


def check_systems(torch, cfg, cal, dev, records):
    """K6 at P = 2, 4, 12 and K7 at P = 2, 4 against their plain versions
    on LM inputs at a point perturbed by +-0.3 in u. Both sum over the bins
    in one order with the same column arithmetic: bit-equal expected at
    both types; the bands allow 1e-12 relative at fp64 and 1e-5 at fp32
    should the card's sin/cos differ from PyTorch's."""
    from npswf_tpu_torch.fit.eval_kernel import (dp_du, fused_eval,
                                                 fused_neq, fused_neq_plain,
                                                 fused_system,
                                                 fused_system_plain,
                                                 to_physical)
    n = cal.nblocks * E_BENCH
    for P, max_pulses in ((2, 2), (4, 4), (12, 6)):
        for dt in (torch.float64, torch.float32):
            (coeffs_pad, x0, y, w, u0, lo, hi, p_seed, pm, _, _, _, _) = \
                lm_inputs(torch, cfg, cal, n, max_pulses, P, 41 + P, dt, dev)
            rng = np.random.default_rng(51 + P)
            u = u0 + torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(u0.shape)),
                                     dtype=dt, device=dev)
            sys_args = (coeffs_pad, x0, y, w, u, lo, hi, p_seed, pm)
            cases = [("K6", "fused_system",
                      lambda: fused_system(cfg, *sys_args),
                      lambda: fused_system_plain(cfg, *sys_args))]
            if P <= 4:
                pp = to_physical(u, lo, hi, p_seed, pm)
                ev = fused_eval(cfg, coeffs_pad, x0, pp[:, 1::2], pp[:, 2::2],
                                pp[:, 0], pm[:, 2::2])
                dd = dp_du(u, lo, hi, pm)
                cases.append(("K7", "fused_neq",
                              lambda: fused_neq(cfg, y, w, *ev, dd),
                              lambda: fused_neq_plain(cfg, y, w, *ev, dd)))
            for tag, name, run_k, run_p in cases:
                k, p = run_k(), run_p()
                torch.cuda.synchronize()
                ndiff = sum(int((x != y_).sum()) for x, y_ in zip(k, p))
                rel = max(float(((x - y_).abs() / y_.abs().clamp(min=1e-30)).max())
                          for x, y_ in zip(k, p))
                err = max(float((x - y_).abs().max()) for x, y_ in zip(k, p))
                say(tag, f"P={P} {dt}: {ndiff} values of A, g, chi2 differ "
                         f"bitwise; max rel {rel:.3e}, max|d| {err:.3e}")
                check(all(bool(torch.isfinite(x).all()) for x in k),
                      f"{name} not finite")
                check(rel <= (1e-12 if dt == torch.float64 else 1e-5),
                      f"{name} off its band at P={P} {dt}")
                if P == 2 and dt == torch.float32:
                    M = 1 + 2 * P
                    K = y.shape[1]
                    if name == "fused_system":
                        nb = nbytes(*sys_args) + nbytes(k[1], k[2]) \
                            + (M * (M + 1) // 2) * n * 4
                        nops = n * ops_system(K, P)
                        lib_ms = None
                    else:
                        nb = nbytes(y, w, *ev, dd) + nbytes(k[1], k[2]) \
                            + (M * (M + 1) // 2) * n * 4
                        nops = n * K * (6 * P + M * (M + 1) + 2 * M + 5)
                        # yardstick: one batched product of X = [Ju | r]
                        # gives A, g and chi2 (the port never calls it)
                        jp = torch.stack([ev[1], ev[2]], dim=2).reshape(n, 2 * P, K)
                        cols = torch.cat([dd[:, :1, None].expand(n, 1, K),
                                          jp * dd[:, 1:, None]], dim=1) * w[:, None, :]
                        X = torch.cat([cols, ((y - ev[0]) * w)[:, None, :]],
                                      dim=1).transpose(1, 2).contiguous()
                        lib_ms = cuda_ms(torch, lambda: torch.bmm(X.mT, X), 20)
                        del jp, cols, X
                    records[name].update(
                        max_abs_err=err,
                        ms=cuda_ms(torch, run_k, 20),
                        plain_ms=cuda_ms(torch, run_p, 3),
                        library_ms=lib_ms, **bound(nb, nops))
                del k, p
            del sys_args, cases


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
    return out, launches


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
    sys.path.insert(0, REPO)
    try:
        return run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1


def run(torch) -> int:
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.trace import ROUTES as ROUTE_FLAGS

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
    N = E * B
    sig64 = torch.as_tensor(truth.signal.reshape(N, T), device=dev)
    lanes = (sig64, sig64.amin(dim=1),
             torch.as_tensor(np.tile(cal.mfkern_rev, (E, 1)), device=dev),
             torch.as_tensor(np.tile(cal.mfint, E), device=dev))
    check_matched_filter(torch, cfg, lanes, records)
    mf32 = matched_filter(cfg, *lanes).to(torch.float32).to(torch.float64)
    check_search(torch, cfg, mf32, sig64, records)
    check_search_topk(torch, cfg, mf32, sig64, records)
    del lanes, mf32
    check_lm(torch, cfg, cal, dev, records)
    check_fused_eval(torch, cfg, cal, dev, records)
    check_systems(torch, cfg, cal, dev, records)
    for route, flags in ROUTE_FLAGS.items():
        n_conv = small_reference(torch, dev, flags)
        say("reference", f"{route}: small fp64 batch, decisions equal to the "
                         f"plain path ({n_conv} converged fits)")

    # ---- 4./5. the routes of the main path, their checks and times -----
    default_out = None
    route_launches = {}
    for route in ROUTES:
        out, route_launches[route] = run_route(
            torch, cfg.replace(**ROUTE_FLAGS[route]), calib, truth, batch,
            route, card, default_out)
        if default_out is None:
            default_out = out
    for name, route in LAUNCHES_FROM.items():
        records[name]["launches"] = route_launches[route].get(name, 0)

    # ---- 6. records -----------------------------------------------------
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
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

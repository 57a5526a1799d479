#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``npswf_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card at the
main path's shapes, drives ``process_batch`` once on the dense 64-event
batch of the full 1080-block calorimeter through the kernels, checks the
result, times the kernel path against the plain path, and prints one JSON
line of kernel records, the card's name and power limit, and a last JSON
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
It imports no jax. Without a CUDA device, or outside the repository, it
exits non-zero and prints no result.
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
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "matched_filter": ("npswf_tpu_torch/csrc/matched_filter.cu",
                       "npswf_tpu/ops/pallas_kernels.py:38"),
    "search_operands": ("npswf_tpu_torch/csrc/search.cu",
                        "npswf_tpu/ops/pallas_search.py:68"),
    "lm_solve": ("npswf_tpu_torch/csrc/lm.cu",
                 "npswf_tpu/fit/pallas_lm.py:122"),
}


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
# inputs
# ---------------------------------------------------------------------
def bench_batch(torch, cfg, cal, dev):
    """bench.py's batch: seed 7, occupancy 1.0, max 2 pulses, pileup 0.25,
    corr_time_HMS from default_rng(11)."""
    from npswf_tpu.utils.synthetic import make_events
    from npswf_tpu_torch.core.params import batch_to_torch
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
    from npswf_tpu_torch.fit.lm import FitInputs, _prepare
    from npswf_tpu_torch.models.waveform import pad_coeffs
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
# phases
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
    records["matched_filter"].update(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: matched_filter_kernel(cfg, *args), 20),
        plain_ms=cuda_ms(torch, lambda: matched_filter(cfg, *args), 20))


def check_search(torch, cfg, src, aux, records):
    """src: the fp32-quantized filter output; aux: the raw signal."""
    from npswf_tpu_torch.ops.peak_search import search_operands
    from npswf_tpu_torch.ops.search_kernel import search_operands_kernel
    N = src.shape[0]
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
        plain_ms=cuda_ms(torch, lambda: search_operands(cfg, s, a, -1), 3))


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
                    records["lm_solve"]["max_abs_err"] = du
                    records["lm_solve"].update(
                        ms=cuda_ms(torch, lambda: lm_solve_kernel(cfg, *args), 3),
                        plain_ms=cuda_ms(torch, lambda: lm_solve_plain(cfg, *args), 1))
            del args, k, p


def check_slice(torch, cfg, calib, truth, batch, records, card):
    """The main path once through the kernels, then checked."""
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.engine.pipeline import process_batch
    E, B, T = batch.signal.shape
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = process_batch(cfg, calib, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    plain = dict(kernels.plain_calls)
    say("slice", f"process_batch E={E} B={B} T={T} fp32 in {first_s:.3f} s; "
                 f"launches {launches}; plain calls {plain}")
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} not launched")
        records[name]["launches"] = launches[name]
    check(sum(plain.values()) == 0, "a plain version ran on the kernel path")
    for f, v in out._asdict().items():
        check(tuple(v.shape[:2]) in ((E, B), (E,), ()), f"{f} shape {v.shape}")
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{f} not finite")
    n_succ, n_fail = int(out.n_fit_success), int(out.n_fit_failure)
    rate = n_fail / max(n_succ + n_fail, 1)
    say("slice", f"pulses {int(out.wfnpulse.sum())}, fits ok {n_succ}, failed "
                 f"{n_fail} ({rate:.4%}), dropped {int(out.n_fit_dropped)}")
    check(rate <= FAIL_RATE_MAX, f"failure rate {rate:.4%} above 2%")
    # truth: single-pulse blocks found with one pulse and fitted
    timeref = calib["timeref"]
    t_rel = (out.wftime[..., 0] - batch.corr_time_HMS[:, None]
             + calib["cortime"][None, :] + calib["timerefacc"] * cfg.dt) / cfg.dt
    one = (torch.as_tensor(truth.npulse, device=out.wfnpulse.device) == 1) \
        & (out.wfnpulse == 1) & out.fit_converged
    dt_bins = (t_rel + timeref[None, :]
               - torch.as_tensor(truth.times[..., 0], device=t_rel.device,
                                 dtype=t_rel.dtype))[one].abs()
    med = float(dt_bins.median())
    say("slice", f"single-pulse blocks {int(one.sum())}: median |t_fit - "
                 f"t_true| {med:.4f} bins")
    check(int(one.sum()) > E * B // 2 and med < 0.05, "fit times off truth")
    ref = process_batch(cfg, calib, batch, plain=True)
    torch.cuda.synchronize()
    np_diff = int((out.wfnpulse != ref.wfnpulse).sum())
    gate_diff = int((out.gate != ref.gate).sum())
    conv_diff = int((out.fit_converged != ref.fit_converged).sum())
    say("slice", f"vs plain path on the card: wfnpulse differs on {np_diff}, "
                 f"gate on {gate_diff}, fit_converged on {conv_diff} of {E * B}")
    check(np_diff == 0 and gate_diff == 0, "wfnpulse/gate differ from plain")
    # times: host clock around synchronized batches, warm-up excluded
    def per_batch(plain, reps):
        process_batch(cfg, calib, batch, plain=plain)
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            process_batch(cfg, calib, batch, plain=plain)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3
    ms_k = per_batch(False, 5)
    ms_p = per_batch(True, 2)
    for name, ms in (("kernel path", ms_k), ("plain path", ms_p)):
        say("times", f"{name}: {ms:.3f} ms per {E}-event batch, "
                     f"{E * B / (ms / 1e3):.0f} blocks/s ({card})")
    return ms_k, ms_p


def small_reference(torch, dev):
    """fp64 on a small batch: every decision of the kernel path equals the
    plain path's on the card."""
    from npswf_tpu.core import NPSConfig, synthetic_calibration
    from npswf_tpu.utils.synthetic import make_events
    from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
    from npswf_tpu_torch.engine.pipeline import process_batch
    cfg = NPSConfig(ncol=5, nlin=6, fit_small_pulses=1, fit_mid_pulses=2)
    cal = synthetic_calibration(cfg, seed=2)
    truth = make_events(cfg, cal, 4, occupancy=0.4, max_pulses=4,
                        pileup_prob=0.9, seed=5)
    calib = calib_to_torch(cal.device_arrays(cfg), dev, torch.float64)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(4), dev,
                           torch.float64)
    k = process_batch(cfg, calib, batch)
    p = process_batch(cfg, calib, batch, plain=True)
    for f in ("wfnpulse", "pulse_valid", "gate", "fit_converged", "fit_n_iter"):
        check(torch.equal(getattr(k, f), getattr(p, f)), f"small fp64 {f} differs")
    check(bool(torch.allclose(k.wftime, p.wftime, rtol=1e-9, atol=1e-9)),
          "small fp64 wftime differs")
    say("reference", f"small fp64 batch: decisions equal to the plain path "
                     f"({int(k.fit_converged.sum())} converged fits)")


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
    from npswf_tpu.core import NPSConfig, synthetic_calibration
    from npswf_tpu_torch import kernels
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
                 f"{time.perf_counter() - t0:.1f} s (nvcc sm_90a)")

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
    del lanes, mf32
    check_lm(torch, cfg, cal, dev, records)
    small_reference(torch, dev)

    # ---- 4./5. the main path, its checks and times ----------------------
    check_slice(torch, cfg, calib, truth, batch, records, card)

    # ---- 6. records -----------------------------------------------------
    for r in records.values():
        for key in ("launches", "max_abs_err", "ms", "plain_ms"):
            check(key in r, f"{r['name']}: {key} not measured")
        say("times", f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
                     f"{r['plain_ms']:.4f} ms ({card})")
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

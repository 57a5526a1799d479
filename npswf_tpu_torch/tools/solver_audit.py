"""Adversarial solver audit: classify LM fit failures via scipy TRF.

Ported from npswf_tpu/tools/solver_audit.py. Every lane the batched LM
escalation (the Minuit2 Migrad replacement, ref TEST_2.C:755-791) flags as
failed is re-minimized by ``scipy.optimize.least_squares`` (bounded
trust-region-reflective, an independent implementation) from the same
seeds, bounds and objective, and classified by the chi^2 the two
optimizers reach:

- ``lm_stuck``      — TRF finds a >5% lower chi^2: the lane had a reachable
                       better minimum the LM missed.
- ``same_minimum``  — both land within 5%: the LM optimized fine but its
                       convergence criterion (MINPACK-style scaled gradient)
                       declined to certify the point.
- ``lm_better``     — TRF stops >5% HIGHER.

The fit problems come from the pre-fit stages the engine runs (peak search
on K1 and K2, cluster gate, error model, seeds and bounds), built on the
device by ``build_fit_inputs``; the fit runs as the pipeline runs it (the
spline model on K3). The classification stays on the host.

Usage: python -m npswf_tpu_torch.tools.solver_audit [--events 16]
[--sample 150] [--cpu]. It runs on the CUDA device unless ``--cpu`` is
given, and exits non-zero without one. It writes the classification table
to stdout (markdown) and a JSON line.
"""
# _residual_fn is copied from npswf_tpu/tools/solver_audit.py;
# tests/test_torch_host.py pins it there.
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.calibration import (CalibrationBundle, spline_eval_np,
                                              synthetic_calibration)
from npswf_tpu_torch.fit.lm import FitInputs, fit_waveforms, _bounds, _seed_params


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_fit_inputs(cfg: NPSConfig, cal: CalibrationBundle,
                     signal: np.ndarray, pres: np.ndarray,
                     device: str = "cuda") -> Tuple[FitInputs, "torch.Tensor"]:
    """The pipeline's fit problems for every (event x block) lane, as
    tensors on ``device`` in the configuration's compute dtype.

    Mirrors ``engine.pipeline.process_batch`` up to the solver call —
    matched-filter peak search, 3x3 cluster gate, error model, seed times
    relative to timeref (ref TEST_2.C:662), pedestal seed from the first 20
    samples (ref :672-676) — with no capacity compaction and no buckets:
    every lane is addressable by its index, at width maxwfpulses.

    Returns (FitInputs over all N = E*B lanes, npulse [N]).
    """
    import torch
    from npswf_tpu_torch.core.params import calib_to_torch
    from npswf_tpu_torch.fit.errors import error_model
    from npswf_tpu_torch.ops.cluster_gate import cluster_gate
    from npswf_tpu_torch.ops.peak_search import find_pulses

    E, B, T = signal.shape
    N = E * B
    dtype = torch.float32 if cfg.compute_dtype == "float32" else torch.float64
    calib = calib_to_torch(cal.device_arrays(cfg), device, dtype)
    sig = torch.as_tensor(np.asarray(signal), dtype=dtype, device=device)
    timeref = calib["timeref"]
    present = (torch.as_tensor(np.asarray(pres).astype(bool), device=device)
               & calib["preswf"][None, :])
    flat_sig = sig.reshape(N, T)
    flat_present = present.reshape(N)
    kern_flat = calib["mfkern_rev"][None].expand(E, B, cfg.mfwidth).reshape(N, -1)
    mfint_flat = calib["mfint"][None].expand(E, B).reshape(N)
    ps = find_pulses(cfg, flat_sig, flat_sig.amin(dim=1), kern_flat,
                     mfint_flat, flat_present)
    timerefacc = torch.as_tensor(calib["timerefacc"], dtype=dtype, device=device)
    gate = cluster_gate(cfg, sig, timeref, timerefacc).reshape(N)
    active = flat_present & gate & (ps.npulse > 0)
    blocks_flat = torch.arange(B, device=device).repeat(E)
    err = error_model(cfg, flat_sig)
    inp = FitInputs(
        y=flat_sig[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
        sigma=err[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
        coeffs=calib["spline_coeffs"][blocks_flat],
        x0=calib["spline_x0"][blocks_flat],
        t_seed=ps.times - timeref[blocks_flat][:, None],
        a_seed=ps.amps,
        ped_seed=flat_sig[:, :cfg.ped_nsamples].mean(dim=1),
        pulse_mask=ps.valid,
        active=active,
        timeref=timeref[blocks_flat])
    return inp, ps.npulse


def _residual_fn(cfg: NPSConfig, coeffs, x0, y, sigma, pmask):
    """f64 residual of the engine's objective for one lane (scipy-side)."""
    xgrid = np.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=np.float64)

    def resid(p):
        f = np.full(xgrid.shape, p[0])
        for q in np.nonzero(pmask)[0]:
            t, a = p[1 + 2 * q], p[2 + 2 * q]
            arg = xgrid - t
            gate = (arg > cfg.spline_gate_lo) & (arg < cfg.ntime - 1)
            f = f + np.where(gate, a * spline_eval_np(coeffs, x0, arg), 0.0)
        return (y - f) / sigma

    return resid


def audit_signal(cfg: NPSConfig, cal: CalibrationBundle, signal: np.ndarray,
                 pres: np.ndarray, sample: int = 150, seed: int = 5,
                 device: str = "cuda") -> Dict[str, float]:
    """Fit all lanes on ``device``, TRF-re-minimize a sample of the failed
    ones on the host."""
    from scipy.optimize import least_squares

    inp, _ = build_fit_inputs(cfg, cal, signal, pres, device)
    # the pipeline's model: the spline planes, solved by K3
    model = "spline_ref_pallas" if cfg.model_name == "spline_ref" else ""
    res = fit_waveforms(cfg, inp, model)
    active = _host(inp.active)
    conv = _host(res.converged)
    failed = np.nonzero(active & ~conv)[0]
    n_fits = int(active.sum())
    out = {"n_fits": n_fits, "n_failed": int(failed.size),
           "fail_rate": failed.size / max(n_fits, 1)}
    if failed.size == 0:
        out.update(n_audited=0, lm_stuck=0, same_minimum=0, lm_better=0)
        return out

    rng = np.random.default_rng(seed)
    take = (failed if failed.size <= sample
            else rng.choice(failed, size=sample, replace=False))
    lo, hi = (_host(v).astype(np.float64) for v in _bounds(cfg, inp))
    p_seed = _host(_seed_params(cfg, inp)).astype(np.float64)
    y = _host(inp.y).astype(np.float64)
    sig = _host(inp.sigma).astype(np.float64)
    coeffs = _host(inp.coeffs).astype(np.float64)
    x0s = _host(inp.x0).astype(np.float64)
    pmask = _host(inp.pulse_mask)
    chi2_lm = _host(res.chi2).astype(np.float64)

    n_stuck = n_same = n_better = 0
    stuck_ratios, stuck_trf_ndf = [], []
    K = cfg.fit_hi_bin - cfg.fit_lo_bin
    for i in take:
        m = 1 + 2 * int(pmask[i].sum())
        # valid pulse slots are a prefix (find_pulses packs them first)
        assert pmask[i, : (m - 1) // 2].all()
        resid = _residual_fn(cfg, coeffs[i], x0s[i], y[i], sig[i], pmask[i])
        sol = least_squares(resid, p_seed[i, :m],
                            bounds=(lo[i, :m], hi[i, :m]), method="trf",
                            xtol=1e-12, ftol=1e-12, gtol=1e-10)
        chi2_trf = float(np.sum(resid(sol.x) ** 2))
        ours = chi2_lm[i]
        if chi2_trf < ours * 0.95:
            n_stuck += 1
            stuck_ratios.append(chi2_trf / max(ours, 1e-12))
            stuck_trf_ndf.append(chi2_trf / max(K - m, 1))
        elif chi2_trf > ours * 1.05:
            n_better += 1
        else:
            n_same += 1
    n_aud = len(take)
    out.update(n_audited=n_aud, lm_stuck=n_stuck, same_minimum=n_same,
               lm_better=n_better,
               lm_stuck_frac=n_stuck / n_aud,
               same_minimum_frac=n_same / n_aud,
               lm_better_frac=n_better / n_aud,
               median_stuck_chi2_ratio=(float(np.median(stuck_ratios))
                                        if stuck_ratios else None),
               # chi2/ndf >> 1 at TRF's minimum: unfittable data, not a
               # solver weakness
               median_stuck_trf_chi2_ndf=(float(np.median(stuck_trf_ndf))
                                          if stuck_trf_ndf else None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--events", type=int, default=16)
    ap.add_argument("--sample", type=int, default=150,
                    help="max failed lanes to TRF-re-minimize per ensemble")
    ap.add_argument("--cpu", action="store_true",
                    help="fit on the CPU (default: the CUDA device)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"],
                    help="fit compute dtype (float64 isolates precision-"
                    "stall failures from algorithmic ones)")
    args = ap.parse_args(argv)
    import torch
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 3

    from npswf_tpu_torch.utils.synthetic import adversarial_variants, make_events

    cfg = NPSConfig(compute_dtype=args.dtype)
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, args.events, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    ensembles = {"clean": truth.signal}
    ensembles.update(adversarial_variants(cfg, cal, truth, seed=23))

    rows = {}
    for name, sig in ensembles.items():
        print(f"[audit] {name}: fitting {args.events * cfg.nblocks} lanes "
              f"on {device}...", file=sys.stderr)
        rows[name] = audit_signal(cfg, cal, sig, truth.pres,
                                  sample=args.sample, device=device)
        print(f"[audit] {name}: {rows[name]}", file=sys.stderr)

    print("| ensemble | fits | failed | rate | audited | lm_stuck | "
          "same_minimum | lm_better |")
    print("|---|---|---|---|---|---|---|---|")
    for name, r in rows.items():
        print(f"| {name} | {r['n_fits']} | {r['n_failed']} | "
              f"{r['fail_rate']:.2%} | {r['n_audited']} | "
              f"{r.get('lm_stuck', 0)} | {r.get('same_minimum', 0)} | "
              f"{r.get('lm_better', 0)} |")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

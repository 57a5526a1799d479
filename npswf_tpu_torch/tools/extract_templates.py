# Copied from npswf_tpu/tools/extract_templates.py; tests/test_torch_host.py pins it there.
"""Reference-template (calibration) extraction from raw data.

The reference CONSUMES per-block reference waveforms prepared outside its
repo (the ``interp_wf`` files parsed at ref TEST_2.C:425-455) and offers no
way to produce them; a collaboration member regenerates them with separate,
unpublished calibration machinery. This tool closes that gap for framework
users: it builds a :class:`CalibrationBundle` directly from a raw segment by

1. selecting pulse candidates per block (pedestal-subtracted amplitude
   above ``amp_min``, interior peak, samples before the pulse onset below
   ``isolation`` x the peak — exposing earlier pileup; the decay tail is
   long and carries no absolute cut),
2. locating each candidate's peak at sub-bin precision (parabolic
   interpolation through the three samples around the maximum), aligning
   all candidates of a block to the block's median peak position with
   Catmull-Rom cubic resampling, and normalizing each to unit peak,
3. forming a per-sample MEDIAN template (robust: pileup at random offsets
   contaminates each sample in a minority of candidates), rejecting
   candidates whose max residual against it exceeds ``resid_max``, and
   averaging the survivors,
4. deriving the per-block fit artifacts exactly as the calibration loader
   does for file-based templates (timeref = argmax quirk, reversed
   unnormalized MF kernel + mfint, natural-cubic-spline coefficients —
   ``core.calibration._derive_block``, ref TEST_2.C:427-451).

Blocks with fewer than ``min_candidates`` accepted waveforms keep the
``base`` bundle's template when one is given, and are marked absent
(``preswf=False``) otherwise — matching the reference's behavior for
missing reference-waveform files (ref :452).

Extraction is deliberately host-side numpy: it is an offline calibration
task (run once per epoch), not part of the hot device pipeline.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from npswf_tpu_torch.core.calibration import CalibrationBundle, _derive_block
from npswf_tpu_torch.core.config import NPSConfig


@dataclass
class ExtractionStats:
    n_events: int = 0
    candidates_per_block: np.ndarray = field(default=None)  # [B] i64, pre-cut
    survivors_per_block: np.ndarray = field(default=None)   # [B] i64, post-cut
    n_extracted: int = 0          # blocks with a data-derived template
    n_from_base: int = 0          # blocks falling back to the base bundle
    n_absent: int = 0             # blocks left preswf=False
    mean_peak_pos: float = 0.0    # mean aligned peak bin over extracted blocks


def _parabolic_peak(y: np.ndarray, imax: np.ndarray):
    """Sub-bin peak position/amplitude from the 3 samples around the max.

    y [N, T], imax [N] (interior bins). Returns (pos [N], amp [N]). Falls
    back to the integer max where the parabola degenerates (flat top).
    """
    n = np.arange(y.shape[0])
    y0 = y[n, imax]
    ym = y[n, imax - 1]
    yp = y[n, imax + 1]
    denom = ym - 2.0 * y0 + yp
    delta = np.where(np.abs(denom) > 1e-12,
                     0.5 * (ym - yp) / np.where(denom == 0, 1.0, denom), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    amp = y0 - 0.25 * (ym - yp) * delta
    return imax.astype(np.float64) + delta, amp


def extract_templates_from_arrays(
        cfg: NPSConfig, signal: np.ndarray, pres: np.ndarray, *,
        base: Optional[CalibrationBundle] = None, run: Optional[int] = None,
        amp_min: float = 20.0, isolation: float = 0.15,
        isolation_halfwidth: int = 20, resid_max: float = 0.15,
        min_candidates: int = 6, edge_margin: int = 8):
    """Extract per-block templates from dense decoded arrays.

    signal [E, B, T] raw ADC samples, pres [E, B] block-read-out mask.
    Returns (CalibrationBundle, ExtractionStats).
    """
    E, B, T = signal.shape
    if B != cfg.nblocks or T != cfg.ntime:
        raise ValueError(f"signal shape {signal.shape} does not match config "
                         f"({cfg.nblocks} blocks x {cfg.ntime} samples)")
    sig = np.asarray(signal, np.float64)
    pres = np.asarray(pres, bool)

    # pedestal from the first ped_nsamples samples (the fit's seed rule,
    # ref TEST_2.C:672-676) — adequate for candidate selection
    ped = sig[:, :, :cfg.ped_nsamples].mean(axis=2)
    y = sig - ped[:, :, None]

    lo, hi = cfg.mfstart, cfg.mfend            # the search window (ref :192-196)
    imax = np.argmax(y[:, :, lo:hi], axis=2) + lo          # [E, B]
    amax = np.take_along_axis(y, imax[:, :, None], axis=2)[:, :, 0]

    # pre-peak isolation: samples more than isolation_halfwidth BEFORE the
    # peak (i.e. before the pulse onset — the window must cover the full
    # rise) must stay below isolation * peak, exposing an earlier pileup
    # pulse. The decay tail is long-lived and gets no absolute cut; pileup
    # riding the tail or the rise is handled by the residual pass below.
    t_idx = np.arange(T)
    before = t_idx[None, None, :] < (imax[:, :, None] - isolation_halfwidth)
    pre_max = np.where(before, y, -np.inf).max(axis=2)

    cand = (pres & (amax >= amp_min)
            & (imax >= max(edge_margin, 1))
            & (imax <= T - 1 - max(edge_margin, 1))
            & (pre_max < isolation * amax))

    eidx, bidx = np.nonzero(cand)
    stats = ExtractionStats(
        n_events=E,
        candidates_per_block=np.bincount(bidx, minlength=B).astype(np.int64))

    interp_x = np.tile(np.arange(T, dtype=np.float64), (B, 1))
    interp_y = np.zeros((B, T))
    preswf = np.zeros(B, bool)
    counts = np.zeros(B, np.int64)

    if eidx.size:
        Y = y[eidx, bidx]                                   # [N, T]
        pos, amp = _parabolic_peak(Y, imax[eidx, bidx])     # [N], [N]

        # per-block alignment target: median sub-bin peak position
        order = np.argsort(bidx, kind="stable")
        tpk = np.zeros(B)
        for b, grp in _groups(bidx[order]):
            tpk[b] = np.median(pos[order[grp]])

        # resample each candidate so its peak lands on its block's target.
        # Catmull-Rom cubic: linear interpolation's O(h^2 f'') smoothing
        # bias at the high-curvature peak is ~5% of the amplitude —
        # visible in the averaged template; the cubic removes it.
        shift = pos - tpk[bidx]                             # [N]
        sample_at = t_idx[None, :] + shift[:, None]         # [N, T]
        i0 = np.clip(np.floor(sample_at).astype(np.int64), 0, T - 2)
        f = sample_at - i0
        rows = np.arange(eidx.size)[:, None]
        pm = Y[rows, np.maximum(i0 - 1, 0)]
        p0 = Y[rows, i0]
        p1 = Y[rows, i0 + 1]
        p2 = Y[rows, np.minimum(i0 + 2, T - 1)]
        y_shift = 0.5 * (2.0 * p0 + (p1 - pm) * f
                         + (2.0 * pm - 5.0 * p0 + 4.0 * p1 - p2) * f * f
                         + (3.0 * (p0 - p1) + p2 - pm) * f * f * f)
        y_norm = y_shift / amp[:, None]

        # robust two-pass per block: median template -> residual cut -> mean
        for b, grp in _groups(bidx[order]):
            rows_b = order[grp]
            if rows_b.size < max(min_candidates, 1):
                continue
            Yb = y_norm[rows_b]                             # [n_b, T]
            med = np.median(Yb, axis=0)
            resid = np.abs(Yb - med[None, :]).max(axis=1)
            keep = resid <= resid_max
            if keep.sum() < max(min_candidates, 1):
                continue
            interp_y[b] = Yb[keep].mean(axis=0)
            counts[b] = int(keep.sum())
            preswf[b] = True

        # template hygiene: remove the residual baseline and renormalize
        # to unit peak. The baseline window must end BEFORE the pulse rise
        # (peak - isolation_halfwidth); for early-peaking blocks the window
        # shrinks, and below 4 samples the subtraction is skipped rather
        # than bias the template with rise samples.
        for b in np.nonzero(preswf)[0]:
            pk_bin = int(np.argmax(interp_y[b]))
            n_base = min(cfg.ped_nsamples, pk_bin - isolation_halfwidth)
            if n_base >= 4:
                interp_y[b] -= interp_y[b, :n_base].mean()
            pk = interp_y[b].max()
            if pk > 0:
                interp_y[b] /= pk
        if preswf.any():
            stats.mean_peak_pos = float(
                np.mean(np.argmax(interp_y[preswf], axis=1)))

    stats.survivors_per_block = counts
    stats.n_extracted = int(preswf.sum())

    # fallback for data-starved blocks
    if base is not None:
        weak = ~preswf & base.preswf
        interp_x[weak] = base.interp_x[weak]
        interp_y[weak] = base.interp_y[weak]
        preswf |= weak
        stats.n_from_base = int(weak.sum())
    stats.n_absent = int((~preswf).sum())

    # absent blocks keep the loader's -1e6 timeref sentinel so the cluster
    # gate's coincidence window (center = timeref + timerefacc) stays empty
    # for them, as with a file-based calibration (core/calibration.py:273)
    timeref = np.full(B, -1.0e6)
    mfkern_rev = np.zeros((B, cfg.mfwidth))
    mfint = np.ones(B)
    spline_coeffs = np.zeros((B, T - 1, 4))
    spline_x0 = np.zeros(B)
    for b in np.nonzero(preswf)[0]:
        tr, kr, mi, co = _derive_block(cfg, interp_x[b], interp_y[b])
        timeref[b] = tr
        mfkern_rev[b] = kr
        mfint[b] = mi
        spline_coeffs[b] = co
        spline_x0[b] = interp_x[b, 0]

    timerefacc = base.timerefacc if base is not None else cfg.timerefacc()
    bundle = CalibrationBundle(
        interp_x=interp_x, interp_y=interp_y, timeref=timeref, preswf=preswf,
        mfkern_rev=mfkern_rev, mfint=mfint,
        tdcoffset=(base.tdcoffset.copy() if base is not None
                   else np.zeros(B)),
        cortime=(base.cortime.copy() if base is not None
                 else np.full(B, -1.0e-7)),   # "zero" in the ref encoding (:464-467)
        timerefacc=timerefacc,
        timemean2=(base.timemean2.copy() if base is not None
                   else np.full(B, cfg.timemean_base + timerefacc * cfg.dt)),
        spline_coeffs=spline_coeffs, spline_x0=spline_x0,
        run=(run if run is not None
             else (base.run if base is not None else 0)))
    return bundle, stats


def estimate_template_shift(ya: np.ndarray, yb: np.ndarray,
                            max_shift: float = 3.0) -> float:
    """Sub-bin time shift delta minimizing sum_t (ya(t + delta) - yb(t))^2.

    The absolute phase of an extracted template is a gauge freedom: it is
    set by the mean arrival time of the pulses that built it (statistical
    error ~ jitter/sqrt(n)) and is absorbed downstream by the cortime/tdc
    timing calibrations, exactly as for the reference's externally-produced
    templates. This helper measures the relative phase of two templates —
    for drift monitoring between calibration epochs, or for phase-free
    shape comparison. Coarse grid search then parabolic refinement.
    """
    t = np.arange(ya.size, dtype=np.float64)

    def sse(d):
        return float(np.sum((np.interp(t + d, t, ya) - yb) ** 2))

    deltas = np.arange(-max_shift, max_shift + 1e-9, 0.1)
    costs = np.array([sse(d) for d in deltas])
    i = int(costs.argmin())
    if 0 < i < deltas.size - 1:
        cm, c0, cp = costs[i - 1], costs[i], costs[i + 1]
        denom = cm - 2.0 * c0 + cp
        frac = 0.5 * (cm - cp) / denom if abs(denom) > 1e-30 else 0.0
        return float(deltas[i] + np.clip(frac, -0.5, 0.5) * 0.1)
    return float(deltas[i])


def _groups(sorted_ids: np.ndarray):
    """Yield (id, slice) for runs of equal values in a sorted id array."""
    if sorted_ids.size == 0:
        return
    bounds = np.nonzero(np.diff(sorted_ids))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [sorted_ids.size]])
    for s, e in zip(starts, ends):
        yield int(sorted_ids[s]), slice(s, e)


def extract_templates(cfg: NPSConfig, seg, *,
                      base: Optional[CalibrationBundle] = None,
                      run: Optional[int] = None,
                      use_native: bool = True, max_events: Optional[int] = None,
                      **kwargs):
    """Decode a RawSegment (raw streams only; HMS not needed) and extract."""
    from npswf_tpu_torch.io.decode import decode_raw
    hi = seg.n_events if max_events is None else min(max_events, seg.n_events)
    signal, pres, _, _ = decode_raw(cfg, seg, 0, hi, use_native=use_native)
    return extract_templates_from_arrays(
        cfg, signal, pres[:, :cfg.nblocks], base=base, run=run, **kwargs)


def compare_bundles(a: CalibrationBundle, b: CalibrationBundle):
    """Per-block template drift between two calibration bundles.

    Returns (delta [B] phase shift in bins, dev [B] max aligned shape
    deviation in peak units); NaN where either block is absent. Use to
    monitor template evolution between calibration epochs (the reference's
    epoch path-ladder at TEST_2.C:377-416 encodes such epochs by hand).
    """
    B = a.nblocks
    t = np.arange(a.interp_y.shape[1], dtype=np.float64)
    delta = np.full(B, np.nan)
    dev = np.full(B, np.nan)
    both = a.preswf & b.preswf
    for blk in np.nonzero(both)[0]:
        d = estimate_template_shift(a.interp_y[blk], b.interp_y[blk])
        aligned = np.interp(t + d, t, a.interp_y[blk])
        delta[blk] = d
        dev[blk] = float(np.max(np.abs(aligned - b.interp_y[blk])))
    return delta, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="raw segment .npz (or, with --compare, "
                                  "the OLD calibration bundle .npz)")
    ap.add_argument("out", help="output calibration bundle .npz (or, with "
                                "--compare, the NEW bundle to compare)")
    ap.add_argument("--compare", action="store_true",
                    help="drift-monitoring mode: report per-block template "
                         "phase shift and aligned shape deviation between "
                         "two bundles instead of extracting")
    ap.add_argument("--run", type=int, default=3000)
    ap.add_argument("--calib", default=None,
                    help="base bundle .npz: supplies tdc/cortime/geometry and "
                         "the fallback template for data-starved blocks")
    ap.add_argument("--amp-min", type=float, default=20.0)
    ap.add_argument("--isolation", type=float, default=0.15)
    ap.add_argument("--min-candidates", type=int, default=6)
    ap.add_argument("--max-events", type=int, default=None)
    ap.add_argument("--no-native", action="store_true")
    args = ap.parse_args(argv)

    if args.compare:
        a = CalibrationBundle.load(args.input)
        b = CalibrationBundle.load(args.out)
        delta, dev = compare_bundles(a, b)
        ok = np.isfinite(delta)
        if not ok.any():
            print("no blocks present in both bundles")
            return 1
        print(f"template drift over {int(ok.sum())} common blocks: "
              f"phase |median| {np.nanmedian(np.abs(delta)):.3f} bins, "
              f"max {np.nanmax(np.abs(delta)):.3f}; "
              f"shape dev median {np.nanmedian(dev):.4f}, "
              f"max {np.nanmax(dev):.4f} (peak units)")
        worst = np.argsort(np.nan_to_num(dev, nan=-1.0))[-5:][::-1]
        for blk in worst:
            if np.isfinite(dev[blk]):
                print(f"  block {blk}: shift {delta[blk]:+.3f} bins, "
                      f"dev {dev[blk]:.4f}")
        return 0

    from npswf_tpu_torch.core.config import config_for_run
    from npswf_tpu_torch.io.rawstream import read_segment
    cfg = config_for_run(args.run)
    base = CalibrationBundle.load(args.calib) if args.calib else None
    seg = read_segment(args.input)
    bundle, st = extract_templates(
        cfg, seg, base=base, run=args.run, use_native=not args.no_native,
        max_events=args.max_events, amp_min=args.amp_min,
        isolation=args.isolation, min_candidates=args.min_candidates)
    bundle.save(args.out)
    print(f"extracted templates for {st.n_extracted}/{cfg.nblocks} blocks "
          f"from {st.n_events} events "
          f"({st.n_from_base} kept from base, {st.n_absent} absent); "
          f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

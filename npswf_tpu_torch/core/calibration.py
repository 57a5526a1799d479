# Copied from npswf_tpu/core/calibration.py; tests/test_torch_host.py pins it
# there.
"""Calibration / reference-data layer.

TPU-native equivalent of the reference's global, read-once calibration state
(ref TEST_2.C:74-85 globals; load loops at :360-469):

- per-block TDC offsets ``tdcoffset[nblocks]`` (ref :370-375)
- per-block reference waveforms ``interpX/interpY[nblocks][ntime]`` selected by
  run-number epoch (ref :377-416), with ``timeref`` = time bin of the waveform
  maximum (ref :427-438, NOT the file's first-line value — parity quirk)
- matched-filter kernels ``mfyref[nblocks][mfwidth]`` = samples around the max,
  and normalization ``mfint`` = sum of the kernel (ref :440-451)
- per-block timing corrections ``cortime`` with exact zeros replaced by -1e-7
  (ref :458-469)
- run-dependent geometry ``calodist -> timerefacc`` and expected pulse time
  ``timemean2`` (ref :498-530)

Plus what the reference computes lazily per fit and we precompute once:
natural-cubic-spline coefficient tensors replacing the per-call
``ROOT::Math::Interpolator`` kCSPLINE construction (ref :612-619).

The hardcoded run-range -> directory if-ladder (ref :377-416) is replaced by a
JSON epoch manifest.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig


# ----------------------------------------------------------------------
# Natural cubic spline (GSL cspline semantics, as used by
# ROOT::Math::Interpolator kCSPLINE at ref TEST_2.C:612-619)
# ----------------------------------------------------------------------
def natural_cubic_spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Piecewise-cubic coefficients of the natural cubic spline through (x, y).

    Returns ``coeffs[n-1, 4]`` with ``s(t) = a + b*u + c*u^2 + d*u^3`` on
    interval i, ``u = t - x[i]``, columns ordered (a, b, c, d).
    Natural boundary: s''(x[0]) = s''(x[-1]) = 0.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 3:
        raise ValueError("need at least 3 knots")
    h = np.diff(x)
    if np.any(h <= 0):
        raise ValueError("knots must be strictly increasing")
    # Tridiagonal system for second derivatives M[1..n-2]; M[0]=M[n-1]=0.
    rhs = 6.0 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    diag = 2.0 * (h[:-1] + h[1:])
    lower = h[:-1].copy()
    upper = h[1:].copy()
    m = n - 2
    # Thomas algorithm.
    cp = np.zeros(m)
    dp = np.zeros(m)
    cp[0] = upper[0] / diag[0]
    dp[0] = rhs[0] / diag[0]
    for i in range(1, m):
        denom = diag[i] - lower[i] * cp[i - 1]
        cp[i] = upper[i] / denom if i < m - 1 else 0.0
        dp[i] = (rhs[i] - lower[i] * dp[i - 1]) / denom
    M = np.zeros(n)
    if m > 0:
        M[m] = dp[m - 1]
        for i in range(m - 2, -1, -1):
            M[i + 1] = dp[i] - cp[i] * M[i + 2]
    a = y[:-1]
    b = (y[1:] - y[:-1]) / h - h * (2.0 * M[:-1] + M[1:]) / 6.0
    c = M[:-1] / 2.0
    d = (M[1:] - M[:-1]) / (6.0 * h)
    return np.stack([a, b, c, d], axis=-1)


def spline_eval_np(coeffs: np.ndarray, x0: float, t: np.ndarray,
                   uniform_dx: float = 1.0) -> np.ndarray:
    """Evaluate spline (numpy, uniform knots) — host-side helper/golden path."""
    t = np.asarray(t, dtype=np.float64)
    nseg = coeffs.shape[0]
    idx = np.clip(np.floor((t - x0) / uniform_dx).astype(np.int64), 0, nseg - 1)
    u = t - (x0 + idx * uniform_dx)
    a, b, c, d = (coeffs[idx, k] for k in range(4))
    return ((d * u + c) * u + b) * u + a


# ----------------------------------------------------------------------
# Epoch manifest (replaces the if-ladder at ref TEST_2.C:377-416)
# ----------------------------------------------------------------------
# Open intervals (lo, hi): epoch applies when lo < run < hi, matching the
# reference's strict comparisons.
DEFAULT_EPOCHS: List[Tuple[int, int, str]] = [
    (6183, 7500, "6171-6183/fit_e_runs/RWF"),
    (6168, 6171, "6151-6168/fit_e_runs/RWF"),
    (5236, 6151, "5217-5236/fit_e_runs/RWF"),
    (5208, 5217, "5183-5208/fit_e_runs/RWF"),
    (3898, 5183, "3883-3898/fit_e_runs/RWF"),
    (2920, 3883, "2900-2920/RWF"),
    (2885, 2900, "2875-2885/RWF"),
    (2871, 2875, "2855-2871/RWF"),
    (1982, 2855, "1969-1982/RWF"),
    (1560, 1961, "1423-1511/RWF"),
]


@dataclass
class EpochManifest:
    """Maps run numbers to calibration file locations."""
    root: str
    epochs: List[Tuple[int, int, str]] = field(default_factory=lambda: list(DEFAULT_EPOCHS))
    tdc_offset_file: str = "tdc_offset_param.txt"
    cortime_file: str = "filetime_step_i.txt"
    refwf_pattern: str = "ref_wf_{block}.txt"

    def refwf_dir(self, run: int) -> Optional[str]:
        for lo, hi, sub in self.epochs:
            if lo < run < hi:
                return os.path.join(self.root, sub)
        return None

    def to_json(self) -> str:
        return json.dumps({
            "root": self.root,
            "epochs": [list(e) for e in self.epochs],
            "tdc_offset_file": self.tdc_offset_file,
            "cortime_file": self.cortime_file,
            "refwf_pattern": self.refwf_pattern,
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "EpochManifest":
        d = json.loads(s)
        return cls(root=d["root"],
                   epochs=[tuple(e) for e in d.get("epochs", DEFAULT_EPOCHS)],
                   tdc_offset_file=d.get("tdc_offset_file", "tdc_offset_param.txt"),
                   cortime_file=d.get("cortime_file", "filetime_step_i.txt"),
                   refwf_pattern=d.get("refwf_pattern", "ref_wf_{block}.txt"))

    @classmethod
    def load(cls, path: str) -> "EpochManifest":
        with open(path) as f:
            return cls.from_json(f.read())


# ----------------------------------------------------------------------
# Calibration bundle
# ----------------------------------------------------------------------
@dataclass
class CalibrationBundle:
    """All read-only per-block calibration state, as dense numpy arrays.

    Shapes use B = nblocks (1080), T = ntime (110), W = mfwidth (11).
    """
    interp_x: np.ndarray      # [B, T] f64 — reference waveform time axis
    interp_y: np.ndarray      # [B, T] f64 — reference waveform amplitudes
    timeref: np.ndarray       # [B] f64 — bin of the waveform max (ref :434-438)
    preswf: np.ndarray        # [B] bool — reference waveform present (ref :452)
    mfkern_rev: np.ndarray    # [B, W] f64 — reversed (UNnormalized) MF kernel
    mfint: np.ndarray         # [B] f64 — kernel normalization, divided per
                              # tap in the filter (ref :440-451, :161)
    tdcoffset: np.ndarray     # [B] f64 (ref :370-375)
    cortime: np.ndarray       # [B] f64 — zeros replaced by -1e-7 (ref :464-467)
    timerefacc: float         # (ref :524)
    timemean2: np.ndarray     # [B] f64 (ref :526-530)
    spline_coeffs: np.ndarray  # [B, T-1, 4] f64 — natural cubic spline (a,b,c,d)
    spline_x0: np.ndarray     # [B] f64 — first knot of each block's spline
    run: int = 0

    @property
    def nblocks(self) -> int:
        return self.interp_y.shape[0]

    # ---- device view --------------------------------------------------
    def device_arrays(self, cfg: NPSConfig) -> Dict[str, "np.ndarray"]:
        """Cast to the configured compute dtype for upload to device."""
        dt = np.dtype(cfg.compute_dtype)
        return {
            "timeref": self.timeref.astype(dt),
            "preswf": self.preswf.astype(np.bool_),
            "mfkern_rev": self.mfkern_rev.astype(dt),
            "mfint": self.mfint.astype(dt),
            "tdcoffset": self.tdcoffset.astype(dt),
            "cortime": self.cortime.astype(dt),
            "timemean2": self.timemean2.astype(dt),
            "spline_coeffs": self.spline_coeffs.astype(dt),
            "spline_x0": self.spline_x0.astype(dt),
            "timerefacc": np.asarray(self.timerefacc, dtype=dt),
        }

    # ---- persistence ---------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path, interp_x=self.interp_x, interp_y=self.interp_y,
            timeref=self.timeref, preswf=self.preswf,
            mfkern_rev=self.mfkern_rev, mfint=self.mfint,
            tdcoffset=self.tdcoffset, cortime=self.cortime,
            timerefacc=np.float64(self.timerefacc), timemean2=self.timemean2,
            spline_coeffs=self.spline_coeffs, spline_x0=self.spline_x0,
            run=np.int64(self.run))

    @classmethod
    def load(cls, path: str) -> "CalibrationBundle":
        z = np.load(path)
        return cls(interp_x=z["interp_x"], interp_y=z["interp_y"],
                   timeref=z["timeref"], preswf=z["preswf"].astype(bool),
                   mfkern_rev=z["mfkern_rev"], mfint=z["mfint"],
                   tdcoffset=z["tdcoffset"], cortime=z["cortime"],
                   timerefacc=float(z["timerefacc"]), timemean2=z["timemean2"],
                   spline_coeffs=z["spline_coeffs"], spline_x0=z["spline_x0"],
                   run=int(z["run"]))


def _derive_block(cfg: NPSConfig, xs: np.ndarray, ys: np.ndarray):
    """timeref / MF kernel / spline for one block's reference waveform.

    Mirrors ref TEST_2.C:427-451: timeref = x of the waveform max; kernel =
    mfwidth samples centered (mfleft back) on the max sample; mfint = sum.
    The reference indexes ``interpY[it + jt - mfleft]`` without bounds checks
    (quirk at :447); we clamp to the valid range.
    """
    imax = int(np.argmax(ys))
    timeref = float(xs[imax])
    idx = np.clip(np.arange(cfg.mfwidth) + imax - cfg.mfleft, 0, cfg.ntime - 1)
    mfyref = ys[idx]
    mfint = float(np.sum(mfyref))
    # FindPulsesMF applies kern = mfyref[mfwidth-1-jt] (ref :160); store
    # reversed so the op is a plain correlation. The kernel is NOT
    # pre-normalized: the reference divides per tap — acc += (delta*kern)/
    # mfint (ref :161) — and the ops reproduce that exact accumulation order,
    # so fp64 runs are bit-equal to the macro's arithmetic.
    kern_rev = mfyref[::-1].copy()
    coeffs = natural_cubic_spline_coeffs(xs, ys)
    return timeref, kern_rev, mfint, coeffs


# ----------------------------------------------------------------------
# File-format loaders (reference text formats)
# ----------------------------------------------------------------------
def load_calibration(cfg: NPSConfig, manifest: EpochManifest, run: int) -> CalibrationBundle:
    """Load calibration from reference-format text files via the manifest.

    File formats (ref TEST_2.C:370-469):
      - tdc_offset_param.txt: one float per block, whitespace separated
      - ref_wf_<block>.txt: first line "timeref dum"; then ntime lines "x y"
      - filetime_step_i.txt: per block "dum cortime dum dum dum"
    """
    B, T = cfg.nblocks, cfg.ntime
    tdc_path = os.path.join(manifest.root, manifest.tdc_offset_file)
    tdcoffset = np.zeros(B)
    if os.path.exists(tdc_path):
        vals = np.loadtxt(tdc_path).ravel()
        tdcoffset[:min(B, vals.size)] = vals[:B]

    cortime = np.zeros(B)
    cor_path = os.path.join(manifest.root, manifest.cortime_file)
    if os.path.exists(cor_path):
        rows = np.loadtxt(cor_path)
        if rows.ndim == 1:
            rows = rows[None, :]
        n = min(B, rows.shape[0])
        cortime[:n] = rows[:n, 1]
    # exact zeros replaced by -1e-7 (ref :464-467)
    cortime[cortime == 0.0] = -1.0e-7

    interp_x = np.tile(np.arange(T, dtype=np.float64), (B, 1))
    interp_y = np.zeros((B, T))
    timeref = np.full(B, -1.0e6)
    preswf = np.zeros(B, dtype=bool)
    mfkern_rev = np.zeros((B, cfg.mfwidth))
    mfint = np.ones(B)
    spline_coeffs = np.zeros((B, T - 1, 4))
    spline_x0 = np.zeros(B)

    refdir = manifest.refwf_dir(run)
    if refdir is not None:
        for b in range(B):
            p = os.path.join(refdir, manifest.refwf_pattern.format(block=b))
            if not os.path.exists(p):
                continue
            data = np.loadtxt(p)
            if data.shape[0] < T + 1:
                continue
            xs = data[1:T + 1, 0]
            ys = data[1:T + 1, 1]
            # The device spline evaluators assume unit knot spacing
            # (idx = floor(t - x0)); a file with a different time axis would
            # silently select wrong segments and mis-scale timeref, so reject
            # it here (the reference handles arbitrary x via
            # ROOT::Math::Interpolator, TEST_2.C:612-619 — resample to a unit
            # grid before feeding such a file to this framework).
            if not np.allclose(np.diff(xs), 1.0, rtol=0, atol=1e-9):
                raise ValueError(
                    f"reference waveform {p}: non-unit knot spacing "
                    f"(dx range [{np.diff(xs).min()}, {np.diff(xs).max()}]); "
                    "resample to a unit time grid")
            interp_x[b] = xs
            interp_y[b] = ys
            tr, kr, mi, co = _derive_block(cfg, xs, ys)
            timeref[b] = tr
            mfkern_rev[b] = kr
            mfint[b] = mi
            spline_coeffs[b] = co
            spline_x0[b] = xs[0]
            preswf[b] = True

    timerefacc = cfg.timerefacc()
    timemean2 = np.full(B, cfg.timemean_base + timerefacc * cfg.dt)
    return CalibrationBundle(
        interp_x=interp_x, interp_y=interp_y, timeref=timeref, preswf=preswf,
        mfkern_rev=mfkern_rev, mfint=mfint, tdcoffset=tdcoffset,
        cortime=cortime, timerefacc=timerefacc, timemean2=timemean2,
        spline_coeffs=spline_coeffs, spline_x0=spline_x0, run=run)


# ----------------------------------------------------------------------
# Synthetic calibration (tests / benchmarks)
# ----------------------------------------------------------------------
def synthetic_pulse_shape(cfg: NPSConfig, peak_bin: float = 40.0,
                          rise: float = 2.5, decay: float = 8.0) -> np.ndarray:
    """A realistic PbWO4/fADC-like pulse shape, unit peak amplitude."""
    t = np.arange(cfg.ntime, dtype=np.float64)
    u = (t - (peak_bin - rise * 3.0)) / rise
    shape = np.where(u > 0, (u ** 2) * np.exp(-u * rise / decay), 0.0)
    m = shape.max()
    return shape / m if m > 0 else shape


def synthetic_calibration(cfg: NPSConfig, run: int = 3000, seed: int = 0,
                          peak_jitter: float = 1.5) -> CalibrationBundle:
    """Per-block synthetic reference waveforms with mild shape variation."""
    rng = np.random.default_rng(seed)
    B, T = cfg.nblocks, cfg.ntime
    interp_x = np.tile(np.arange(T, dtype=np.float64), (B, 1))
    interp_y = np.zeros((B, T))
    timeref = np.zeros(B)
    mfkern_rev = np.zeros((B, cfg.mfwidth))
    mfint = np.ones(B)
    spline_coeffs = np.zeros((B, T - 1, 4))
    spline_x0 = np.zeros(B)
    peaks = 40.0 + peak_jitter * rng.standard_normal(B)
    rises = 2.5 + 0.2 * rng.standard_normal(B)
    decays = 8.0 + 0.5 * rng.standard_normal(B)
    for b in range(B):
        ys = synthetic_pulse_shape(cfg, peaks[b], abs(rises[b]) + 0.5,
                                   abs(decays[b]) + 1.0)
        interp_y[b] = ys
        tr, kr, mi, co = _derive_block(cfg, interp_x[b], ys)
        timeref[b] = tr
        mfkern_rev[b] = kr
        mfint[b] = mi
        spline_coeffs[b] = co
        spline_x0[b] = interp_x[b, 0]
    timerefacc = cfg.timerefacc()
    return CalibrationBundle(
        interp_x=interp_x, interp_y=interp_y, timeref=timeref,
        preswf=np.ones(B, dtype=bool), mfkern_rev=mfkern_rev, mfint=mfint,
        tdcoffset=0.1 * rng.standard_normal(B),
        cortime=np.where(rng.random(B) < 0.02, -1.0e-7,
                         0.5 * rng.standard_normal(B)),
        timerefacc=timerefacc,
        timemean2=np.full(B, cfg.timemean_base + timerefacc * cfg.dt),
        spline_coeffs=spline_coeffs, spline_x0=spline_x0, run=run)

# Copied from npswf_tpu/utils/synthetic.py; tests/test_torch_host.py pins it
# there.
"""Synthetic event generation for tests and benchmarks.

Generates raw waveform batches with known ground truth by sampling pulses
from each block's calibration reference shape (the same model the fit
assumes, ref TEST_2.C:621-635), plus pedestal and Gaussian noise. Used to
validate recovery of amplitudes/times and to drive throughput benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from npswf_tpu_torch.core.calibration import CalibrationBundle, spline_eval_np
from npswf_tpu_torch.core.config import NPSConfig


@dataclass
class SyntheticTruth:
    signal: np.ndarray      # [E, B, T] f64 waveforms
    pres: np.ndarray        # [E, B] int32 block-present flags
    npulse: np.ndarray      # [E, B] int32 true pulse count
    times: np.ndarray       # [E, B, Pmax] f64 true pulse peak bins (abs)
    amps: np.ndarray        # [E, B, Pmax] f64 true amplitudes
    pedestal: np.ndarray    # [E, B] f64 true pedestals


def make_events(cfg: NPSConfig, cal: CalibrationBundle, n_events: int,
                occupancy: float = 0.05, max_pulses: int = 2,
                noise: float = 0.5, amp_range: Tuple[float, float] = (20.0, 200.0),
                time_jitter: float = 3.0, pedestal_range: Tuple[float, float] = (-5.0, 5.0),
                seed: int = 0, pileup_prob: float = 0.3) -> SyntheticTruth:
    """Random events: each present block gets 1..max_pulses pulses near timeref.

    ``occupancy`` is the fraction of blocks with a pulse; pulses are placed at
    timeref + jitter (plus a displaced pileup pulse with ``pileup_prob``).
    """
    rng = np.random.default_rng(seed)
    E, B, T = n_events, cfg.nblocks, cfg.ntime
    Pmax = max(1, max_pulses)
    signal = np.zeros((E, B, T))
    pres = np.ones((E, B), dtype=np.int32)  # all blocks read out (dense events)
    npulse = np.zeros((E, B), dtype=np.int32)
    times = np.zeros((E, B, Pmax))
    amps = np.zeros((E, B, Pmax))
    pedestal = rng.uniform(*pedestal_range, size=(E, B))

    x = np.arange(T, dtype=np.float64)
    signal += pedestal[..., None]
    if noise > 0:
        signal += noise * rng.standard_normal((E, B, T))

    active = rng.random((E, B)) < occupancy
    for e in range(E):
        for b in np.nonzero(active[e])[0]:
            k = 1
            if max_pulses > 1 and rng.random() < pileup_prob:
                k = rng.integers(2, max_pulses + 1)
            tr = cal.timeref[b]
            for p in range(k):
                dt0 = time_jitter * rng.standard_normal()
                if p > 0:
                    dt0 += rng.uniform(-30.0, 30.0)
                t0 = np.clip(tr + dt0, 15.0, 95.0)
                a0 = rng.uniform(*amp_range)
                # pulse = a0 * ref(x - (t0 - timeref)) with the support gate
                arg = x - (t0 - tr)
                gate = (arg > cfg.spline_gate_lo) & (arg < T - 1)
                vals = spline_eval_np(cal.spline_coeffs[b], cal.spline_x0[b], arg)
                signal[e, b] += np.where(gate, a0 * vals, 0.0)
                times[e, b, p] = t0
                amps[e, b, p] = a0
            npulse[e, b] = k
    return SyntheticTruth(signal=signal, pres=pres, npulse=npulse,
                          times=times, amps=amps, pedestal=pedestal)


def adversarial_variants(cfg: NPSConfig, cal: CalibrationBundle,
                         truth: SyntheticTruth, seed: int = 23):
    """The three solver-stress ensembles: wrong pulse shape, correlated
    (non-white) noise, and ADC-saturated (clipped) pulses.

    The clean-synthetic failure rate is measured on waveforms generated from
    the SAME spline model the fit assumes, so it is NOT comparable to the
    reference's 1-2% on real detector data (ref README.md:129); these
    variants stress the solver the way real data does. Shared between
    ``bench.py`` (failure-rate diagnostics) and ``tools/solver_audit.py``
    (the scipy-TRF failure classification) so both see identical data.

    Returns an ordered dict name -> signal [E, B, T] (f64).
    """
    rng_a = np.random.default_rng(seed)
    x = np.arange(cfg.ntime, dtype=np.float64)
    # wrong shape: gaussian pulses where the fit assumes the spline template
    wrong = truth.pedestal[..., None] + 0.5 * rng_a.standard_normal(
        truth.signal.shape)
    centers = np.where(truth.times[..., :1] > 0, truth.times[..., :1],
                       cal.timeref[None, :, None])
    wrong += np.maximum(truth.amps[..., :1], 40.0) * np.exp(
        -0.5 * ((x[None, None, :] - centers) / 3.0) ** 2)
    # correlated noise: 7-bin moving-average noise, 4x amplitude
    white = rng_a.standard_normal(truth.signal.shape)
    corr_noise = np.cumsum(white, axis=-1)
    corr_noise[..., 7:] -= corr_noise[..., :-7].copy()
    corr = truth.signal + 4.0 * corr_noise / np.sqrt(7.0)
    # clipped: scale up then saturate at a fixed ADC ceiling
    clipped = np.minimum(truth.signal * 6.0, 600.0)
    return {"wrong_shape": wrong, "correlated_noise": corr,
            "clipped": clipped}

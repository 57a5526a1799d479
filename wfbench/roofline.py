"""The least time the card could take for a kernel's work: the larger of its
bytes over the memory rate and its operations over the dtype's peak.

The counts are of the problem's work, not of today's arrays, so a later
change of a kernel's layout does not move them: each lane's waveform read
once, the spline table read once as ``nblocks`` x 4 x 128 values (not once
a lane), seeds and bounds read once, outputs written once; the operations
those inputs need (for the fit: the iterations the lanes spent, at each
lane's own pulse count). Peaks: NVIDIA's H100 SXM data sheet, without the
tensor cores.
"""
from __future__ import annotations

import numpy as np

MEM_RATE = 3.35e12                      # bytes/s
PEAK = {"float32": 67e12, "float64": 34e12}   # FLOP/s
DTYPE_BYTES = {"float32": 4, "float64": 8}
SPLINE_PLANE = 128                      # a block's padded segment row


def bound(nbytes: float, nops: float, dtype: str) -> dict:
    t_mem = nbytes / MEM_RATE
    t_ops = nops / PEAK[dtype]
    return {"seconds": max(t_mem, t_ops),
            "by": "bytes" if t_mem >= t_ops else "operations",
            "bytes": float(nbytes), "operations": float(nops),
            "peak_flops": PEAK[dtype], "mem_rate": MEM_RATE}


def search_ops_per_lane(g, T: int) -> float:
    """Arithmetic operations of the TSpectrum search of one lane over its
    extended frame (each add, multiply, divide, compare or transcendental
    once): Markov 12 a window step + 4, weights 6, the Gold response 2 a
    tap, each deconvolution iteration 2 a tap of the autocorrelation + 4,
    the centroid 15."""
    shift = int(7.0 * g.spec_sigma + 0.5)
    size_ext = T + 2 * shift
    lh_gold = 0
    for i in range(size_ext):
        lda = (i - 3.0 * g.spec_sigma) ** 2 / (2.0 * g.spec_sigma ** 2)
        if int(1000.0 * np.exp(-lda)) != 0:
            lh_gold = i + 1
    per_bin = (12 * g.spec_aver_window + 4 + 6 + 2 * lh_gold
               + g.spec_decon_iterations * (2 * (2 * lh_gold - 1) + 4) + 15)
    return float(size_ext * per_bin)


def search_bound(g, n_lanes: int, dtype: str) -> dict:
    """The peak search of ``n_lanes`` searched lanes: the filtered and the
    raw waveform read once, the top-``maxwfpulses`` slots (key, centroid,
    height, raw sample) written once."""
    T = g.ntime
    b = DTYPE_BYTES[dtype]
    nbytes = n_lanes * (2 * T + 4 * g.maxwfpulses) * b
    return bound(nbytes, n_lanes * search_ops_per_lane(g, T), dtype)


def system_ops(K: int, P: int) -> float:
    """One evaluation of a lane's spline model and normal equations at P
    pulses over K bins: 25 operations a pulse and bin, 2 an entry of the
    packed system, the transform."""
    M = 1 + 2 * P
    MT = M * (M + 1) // 2
    return float(K * (25 * P + 2 * MT + 2 * M + 5) + 5 * M + 5 * P)


def solve_ops(P: int) -> float:
    """One damped, scaled Cholesky solve of a lane's M x M system."""
    M = 1 + 2 * P
    return float(M ** 3 + 4 * M * M + 10 * M)


def lm_bound(g, npulse: np.ndarray, n_iter: np.ndarray, dtype: str) -> dict:
    """The fit of the lanes given by their pulse counts and the iterations
    they spent (every stage and retry): one system evaluation an iteration
    and one to start, one solve an iteration; the fit window of each lane's
    waveform, its seeds and bounds (3 M values) read once, its parameters,
    chi2, flag and iterations (M + 3) written once, the spline table of
    ``nblocks`` blocks read once."""
    npulse = np.asarray(npulse, np.int64).ravel()
    n_iter = np.asarray(n_iter, np.float64).ravel()
    K = g.nfitbins
    b = DTYPE_BYTES[dtype]
    nops = 0.0
    nvals = 0.0
    for p in np.unique(npulse):
        sel = npulse == p
        it = n_iter[sel]
        M = 1 + 2 * int(p)
        nops += float(((it + 1) * system_ops(K, int(p))
                       + it * solve_ops(int(p))).sum())
        nvals += sel.sum() * (K + 3 * M + M + 3)
    nbytes = nvals * b + g.nblocks * 4 * SPLINE_PLANE * b
    return bound(nbytes, nops, dtype)

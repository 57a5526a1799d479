"""Batched matched filter: the plain PyTorch version of the K1 kernel.

Counterpart of npswf_tpu/ops/matched_filter.py (reference FindPulsesMF,
TEST_2.C:145-171): an 11-tap correlation of each lane's waveform against
its reversed, unnormalized reference kernel, with the baseline subtracted
and the divide by ``mfint`` applied per tap in ascending tap order
(acc += (delta*kern)/mfint, ref :158-161), so fp64 results are bit-equal to
the macro's arithmetic; then the window minimum is subtracted and the bins
outside [mfleft, T-mfright) are zero.
"""
from __future__ import annotations

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels


def matched_filter(cfg: NPSConfig, signal: torch.Tensor,
                   minsignal: torch.Tensor, kern_rev: torch.Tensor,
                   mfint: torch.Tensor) -> torch.Tensor:
    """signal [N, T], minsignal [N], kern_rev [N, W], mfint [N] -> [N, T]."""
    kernels.count_plain(kernels.MATCHED_FILTER)
    T, W, R = cfg.ntime, cfg.mfwidth, cfg.mfright
    lo, hi = cfg.mfleft, T - cfg.mfright
    n = hi - lo
    delta = signal - minsignal[:, None]
    inv = mfint[:, None]
    acc = torch.zeros(signal.shape[:-1] + (n,), dtype=signal.dtype,
                      device=signal.device)
    for jt in range(W):
        # window position it in [lo, hi) reads sample it + jt - mfright
        acc = acc + (delta[:, jt + lo - R: jt + lo - R + n]
                     * kern_rev[:, jt:jt + 1]) / inv
    acc = acc - acc.amin(dim=1, keepdim=True)
    out = torch.zeros_like(signal)
    out[:, lo:hi] = acc
    return out

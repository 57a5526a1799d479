"""Batched natural-cubic-spline evaluation with the model support gate.

Counterpart of npswf_tpu/ops/spline.py (ref TEST_2.C:612-635): per-block
coefficients precomputed on the host, evaluation as a segment gather plus a
Horner step, with the analytic first derivative for the fit Jacobian. Knots
are uniform with unit spacing; the gate spline_gate_lo < t < ntime - 1
zeroes contributions outside the pulse support.
"""
from __future__ import annotations

import torch

from npswf_tpu_torch.core.config import NPSConfig


def _segments(coeffs: torch.Tensor, x0: torch.Tensor, t: torch.Tensor):
    """Segment coefficients (a, b, c, d) and local offset u at each t."""
    nseg = coeffs.shape[-2]
    rel = t - x0[..., None]
    idx = torch.clamp(torch.floor(rel).long(), 0, nseg - 1)
    u = rel - idx.to(t.dtype)
    c4 = torch.gather(coeffs, -2, idx[..., None].expand(idx.shape + (4,)))
    return c4.unbind(-1), u


def spline_eval(cfg: NPSConfig, coeffs: torch.Tensor, x0: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """s(t) without the gate. coeffs [..., S, 4], x0 [...], t [..., K]."""
    (a, b, c, d), u = _segments(coeffs, x0, t)
    return ((d * u + c) * u + b) * u + a


def spline_eval_grad(cfg: NPSConfig, coeffs: torch.Tensor, x0: torch.Tensor,
                     t: torch.Tensor):
    """(s(t), s'(t)) with the support gate applied; zero outside."""
    (a, b, c, d), u = _segments(coeffs, x0, t)
    val = ((d * u + c) * u + b) * u + a
    dval = (3.0 * d * u + 2.0 * c) * u + b
    gate = (t > cfg.spline_gate_lo) & (t < cfg.ntime - 1)
    return torch.where(gate, val, 0.0), torch.where(gate, dval, 0.0)

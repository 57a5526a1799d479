"""Batched small SPD solves for the LM fit.

Counterpart of npswf_tpu/fit/linalg.py: the damped, Jacobi-scaled normal
equations are SPD by construction (unit diagonal + lambda), so an unrolled
outer-product Cholesky with forward/back substitution needs no pivoting.
"""
from __future__ import annotations

import torch


def cholesky_solve(A: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-30) -> torch.Tensor:
    """Solve A x = b for SPD A. A [N, M, M], b [N, M] -> x [N, M]."""
    N, M, _ = A.shape
    idx = torch.arange(M, device=A.device)
    L = torch.zeros_like(A)
    S = A
    for j in range(M):
        d = torch.sqrt(torch.clamp(S[:, j, j], min=eps))
        col = torch.where(idx[None, :] >= j, S[:, :, j] / d[:, None], 0.0)
        L[:, :, j] = col
        S = S - col[:, :, None] * col[:, None, :]
    # substitutions accumulate term by term, in the K3 kernel's order
    y = torch.zeros_like(b)
    for i in range(M):
        acc = b[:, i]
        for k in range(i):
            acc = acc - L[:, i, k] * y[:, k]
        y[:, i] = acc / L[:, i, i]
    x = torch.zeros_like(b)
    for i in range(M - 1, -1, -1):
        acc = y[:, i]
        for k in range(i + 1, M):
            acc = acc - L[:, k, i] * x[:, k]
        x[:, i] = acc / L[:, i, i]
    return x

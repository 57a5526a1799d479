"""K3 wrapper: one whole LM stage per lane on the card (csrc/lm.cuh, lm.cu,
lm_wide.cu).

Replaces npswf_tpu/fit/pallas_lm.py::_lm_kernel (wrappers ``_lm_call`` and
``lm_solve_pallas``), with the signature and return of
``lm_solve_pallas``. CPU tensors go to the plain version, ``lm_solve_plain``; CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.fit.eval_kernel import SEG, system_plain_body
from npswf_tpu_torch.fit.lm import CHOL_EPS, SAT_THRESH, lm_loop

# Widths 1..LM_COMPILED_PULSES have an instantiation each (csrc/lm.cuh,
# kMaxP: one row of the M x M system a thread of the 32-thread team); wider
# ones run lm_wide.cu with P at run time, a block of 128 or 256 threads a
# lane, up to lm_max_pulses. 12 is the default pallas_lm_max_pulses.
LM_COMPILED_PULSES = 15


def lm_max_pulses(K: int, dtype: torch.dtype, device=None) -> int:
    """The widest pulse count K3 takes over K fit bins at ``dtype`` on
    ``device`` (default the current card): a wide lane's arrays must fit
    one block's shared memory (csrc/lm_wide.cu; at K = 90 on an H100, 77
    in fp64 and 112 in fp32). Asked of the card once a (card, dtype, K)."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _max_pulses(index, dtype, int(K))


@functools.lru_cache(maxsize=None)
def _max_pulses(index: int, dtype: torch.dtype, K: int) -> int:
    with torch.cuda.device(index):
        return int(kernels.library().npswf_lm_max_pulses(
            kernels.dtype_code(dtype), K))


def lm_solve_plain(cfg: NPSConfig, coeffs_pad, x0, y, w, u0, lo, hi, p_seed,
                   param_mask, active, max_iter: int, lam0, iter_budget=None):
    """The plain version of the kernel, on any device: the generic LM
    iteration (``fit.lm.lm_loop``) with the plain K6 arithmetic (the plain
    K5 evaluation, then the normal equations summed in bin order), the
    system K3 evaluates inside its loop."""
    kernels.count_plain(kernels.LM_SOLVE)

    def system(u):
        return system_plain_body(cfg, coeffs_pad, x0, y, w, u, lo, hi, p_seed,
                                 param_mask)
    return lm_loop(cfg, system, u0, lo, hi, param_mask, active, max_iter,
                   lam0, iter_budget)


def lm_solve_kernel(cfg: NPSConfig, coeffs_pad: torch.Tensor,
                    x0: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    u0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    p_seed: torch.Tensor, param_mask: torch.Tensor,
                    active: torch.Tensor, max_iter: int, lam0,
                    iter_budget: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Spline-model LM stage on lanes ``active``.

    coeffs_pad [N, 4, SEG] padded planes, x0 [N], y/w [N, K] (w = 1/sigma
    over the fit window), u0/lo/hi/p_seed/param_mask [N, M], active [N]
    bool, lam0 scalar or [N], iter_budget [N] int or None.
    Returns (u, chi2, converged, n_iter, edm, lam) like ``lm.lm_solve``.
    """
    if not u0.is_cuda:
        return lm_solve_plain(cfg, coeffs_pad, x0, y, w, u0, lo, hi, p_seed,
                              param_mask, active, max_iter, lam0, iter_budget)
    N, M = u0.shape
    P = (M - 1) // 2
    dev, dt = u0.device, u0.dtype
    K = y.shape[1]
    lib = kernels.library()
    # widths above the compiled ones must fit a block (asked once a card)
    if (M != 1 + 2 * P or P < 1 or (P > LM_COMPILED_PULSES
                                    and P > lm_max_pulses(K, dt, dev))):
        raise ValueError(f"LM kernel takes 1..{lm_max_pulses(K, dt, dev)} "
                         f"pulses over {K} fit bins in {dt} (a lane's arrays "
                         f"in one block's shared memory), not {P} (M = {M})")
    kernels.require(coeffs_pad, "coeffs_pad", (N, 4, SEG), dt, dev)
    kernels.require(x0, "x0", (N,), dt, dev)
    for name, t in (("u0", u0), ("lo", lo), ("hi", hi), ("p_seed", p_seed)):
        kernels.require(t, name, (N, M), dt, dev)
    for name, t in (("y", y), ("w", w)):
        if tuple(t.shape) != (N, K) or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} must be [{N}, {K}] {dt} on {dev}")
    if tuple(param_mask.shape) != (N, M) or tuple(active.shape) != (N,):
        raise ValueError("param_mask must be [N, M] and active [N]")
    if iter_budget is None:
        iter_budget = torch.full((N,), max_iter, dtype=torch.int32, device=dev)
    budget = torch.clamp(iter_budget.to(device=dev, dtype=torch.int32),
                         max=max_iter).contiguous()
    lam0_t = (torch.zeros((N,), dtype=dt, device=dev) + lam0).contiguous()
    # lanes-minor fit data ([K, N]); each lane's team stages
    # its own bins into shared memory once
    yt = y.t().contiguous()
    wt = w.t().contiguous()
    pmask = param_mask.to(torch.uint8).contiguous()
    act = active.to(torch.uint8).contiguous()
    u = torch.empty((N, M), dtype=dt, device=dev)
    chi2 = torch.empty((N,), dtype=dt, device=dev)
    conv = torch.empty((N,), dtype=torch.uint8, device=dev)
    n_iter = torch.empty((N,), dtype=torch.int32, device=dev)
    edm = torch.empty((N,), dtype=dt, device=dev)
    lam = torch.empty((N,), dtype=dt, device=dev)
    if N == 0:
        return u, chi2, conv.bool(), n_iter, edm, lam
    ins = (coeffs_pad, x0, yt, wt, u0, lo, hi, p_seed, pmask, act, budget,
           lam0_t)
    outs = (u, chi2, conv, n_iter, edm, lam)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))
    eps = float(torch.finfo(dt).eps)
    code = lib.npswf_lm_solve(
        kernels.dtype_code(dt), P, in_ptrs, out_ptrs, N, K, cfg.fit_lo_bin,
        int(max_iter), float(cfg.lm_lambda_up), float(cfg.lm_lambda_down),
        float(cfg.lm_lambda_min), float(cfg.lm_lambda_max),
        max(cfg.lm_ftol, 100.0 * eps), max(cfg.lm_gtol, 100.0 * eps), eps,
        float(cfg.spline_gate_lo), float(cfg.ntime - 1), SAT_THRESH, CHOL_EPS,
        kernels.stream_ptr(dev))
    kernels.check(code, kernels.LM_SOLVE)
    kernels.count_launch(kernels.LM_SOLVE)
    return u, chi2, conv.bool(), n_iter, edm, lam

"""K3 wrappers: one whole LM stage per lane on the card (csrc/lm.cuh, lm.cu,
lm_wide.cu), or the fit's whole retry ladder in one launch.

Replaces npswf_tpu/fit/pallas_lm.py::_lm_kernel (wrappers ``_lm_call`` and
``lm_solve_pallas``): ``lm_solve_kernel`` with the signature and return of
``lm_solve_pallas``. ``lm_ladder_kernel`` runs stage 1, the stage-2
restart and the pull-back rungs of ``fit.lm.fit_waveforms`` in one launch
at the compiled widths. CPU tensors go to the plain versions,
``lm_solve_plain`` and ``lm_ladder_plain``; CUDA tensors launch the kernel
or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.fit.eval_kernel import SEG, system_plain_body
from npswf_tpu_torch.fit.lm import (CHOL_EPS, SAT_THRESH, host_ladder,
                                    ladder_rungs, lm_loop)

# Widths 1..LM_COMPILED_PULSES have an instantiation each (csrc/lm.cuh,
# kMaxP: one row of the M x M system a thread of the 32-thread team); wider
# ones run lm_wide.cu with P at run time, a block of 128 or 256 threads a
# lane, up to lm_max_pulses. 12 is the default pallas_lm_max_pulses.
LM_COMPILED_PULSES = 15
# the pull-back values of a ladder launch on each device, fp64, made once
# (a copy from the host waits for the card)
_PULLBACKS = {}


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


def ladder_pullbacks(cfg: NPSConfig, device: torch.device) -> torch.Tensor:
    """The pull-back values of a ladder launch on ``device`` (fp64), made
    on first use and kept; a CUDA graph's capture, which may copy nothing
    from the host, finds them made."""
    key = (device, tuple(map(float, cfg.lm_stage3_pullbacks)))
    pullbacks = _PULLBACKS.get(key)
    if pullbacks is None:
        pullbacks = _PULLBACKS[key] = torch.tensor(
            key[1], dtype=torch.float64, device=device)
    return pullbacks


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


def lm_ladder_plain(cfg: NPSConfig, coeffs_pad, x0, y, w, u0, lo, hi,
                    p_seed, param_mask, active, s1_cap: int, s1_budget,
                    s2_cap: int, s2_budget):
    """The plain version of the ladder launch, on any device: the host
    ladder (``fit.lm.host_ladder``) over ``lm_solve_plain``, each rung on
    the lanes it retries. Returns ``lm_ladder_kernel``'s tuple."""
    lanes = (coeffs_pad, x0, y, w, lo, hi, p_seed, param_mask)

    def solve(lanes_, u, active_, max_iter, lam0, budget):
        c, x, y_, w_, lo_, hi_, ps, pm = lanes_
        return lm_solve_plain(cfg, c, x, y_, w_, u, lo_, hi_, ps, pm, active_,
                              max_iter, lam0, budget)
    *stages, rungs = host_ladder(cfg, solve, lanes, u0, param_mask, active,
                                 s1_cap, s1_budget, s2_cap, s2_budget)
    return (*stages, torch.tensor(rungs, dtype=torch.int32, device=u0.device))


def _launch(cfg: NPSConfig, coeffs_pad, x0, y, w, u0, lo, hi, p_seed,
            param_mask, active, max_iter: int, lam0, iter_budget,
            ladder=None):
    """Check the arrays and launch K3 once: one stage, or with ``ladder``
    = (s2_cap, s2_budget) the whole ladder. Returns the outputs: (u, chi2,
    conv, n_iter, edm, lam), then with ``ladder`` (u2, chi2_2, conv2, it2,
    rung_lanes)."""
    N, M = u0.shape
    P = (M - 1) // 2
    dev, dt = u0.device, u0.dtype
    K = y.shape[1]
    lib = kernels.library()
    if ladder is not None and not 1 <= P <= LM_COMPILED_PULSES:
        raise ValueError(f"the LM ladder launch takes 1..{LM_COMPILED_PULSES}"
                         f" pulses, not {P} (M = {M})")
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

    def budget_of(b, cap):
        if b is None:
            return torch.full((N,), cap, dtype=torch.int32, device=dev)
        return torch.clamp(b.to(device=dev, dtype=torch.int32),
                           max=cap).contiguous()
    budget = budget_of(iter_budget, max_iter)
    lam0_t = (torch.zeros((N,), dtype=dt, device=dev) + lam0).contiguous()
    # lanes-minor fit data ([K, N]); each lane's team stages
    # its own bins into shared memory once
    yt = y.t().contiguous()
    wt = w.t().contiguous()
    pmask = param_mask.to(torch.uint8).contiguous()
    act = active.to(torch.uint8).contiguous()
    outs = [torch.empty((N, M), dtype=dt, device=dev),
            torch.empty((N,), dtype=dt, device=dev),
            torch.empty((N,), dtype=torch.uint8, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev),
            torch.empty((N,), dtype=dt, device=dev),
            torch.empty((N,), dtype=dt, device=dev)]
    budget2 = pullbacks = None
    rungs, max_iter2 = 0, 0
    if ladder is not None:
        max_iter2, b2 = ladder
        budget2 = budget_of(b2, max_iter2)
        rungs = ladder_rungs(cfg)
        if rungs > 1:
            pullbacks = ladder_pullbacks(cfg, dev)
        outs += [torch.empty((N, M), dtype=dt, device=dev),
                 torch.empty((N,), dtype=dt, device=dev),
                 torch.empty((N,), dtype=torch.uint8, device=dev),
                 torch.empty((N,), dtype=torch.int32, device=dev),
                 torch.zeros((rungs,), dtype=torch.int32, device=dev)]
    if N > 0:
        ins = (coeffs_pad, x0, yt, wt, u0, lo, hi, p_seed, pmask, act, budget,
               lam0_t, budget2, pullbacks)
        in_ptrs = (ctypes.c_void_p * len(ins))(
            *(None if t is None else t.data_ptr() for t in ins))
        out_ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in outs))
        eps = float(torch.finfo(dt).eps)
        code = lib.npswf_lm_solve(
            kernels.dtype_code(dt), P, in_ptrs, out_ptrs, N, K,
            cfg.fit_lo_bin, int(max_iter), int(max_iter2), rungs,
            float(cfg.lm_lambda_up), float(cfg.lm_lambda_down),
            float(cfg.lm_lambda_min), float(cfg.lm_lambda_max),
            max(cfg.lm_ftol, 100.0 * eps), max(cfg.lm_gtol, 100.0 * eps), eps,
            float(cfg.spline_gate_lo), float(cfg.ntime - 1), SAT_THRESH,
            CHOL_EPS, float(cfg.lm_lambda_init) * 10.0,
            float(cfg.lm_lambda_init), kernels.stream_ptr(dev))
        kernels.check(code, kernels.LM_SOLVE)
        kernels.count_launch(kernels.LM_SOLVE)
    for i in ((2, 8) if ladder is not None else (2,)):
        outs[i] = outs[i].bool()
    return tuple(outs)


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
    return _launch(cfg, coeffs_pad, x0, y, w, u0, lo, hi, p_seed, param_mask,
                   active, max_iter, lam0, iter_budget)


def lm_ladder_kernel(cfg: NPSConfig, coeffs_pad: torch.Tensor,
                     x0: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     u0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     p_seed: torch.Tensor, param_mask: torch.Tensor,
                     active: torch.Tensor, s1_cap: int, s1_budget,
                     s2_cap: int, s2_budget) -> Tuple[torch.Tensor, ...]:
    """The fit's ladder in one K3 launch at P <= LM_COMPILED_PULSES: stage 1
    from u0 (lm_lambda_init, s1_budget, at most s1_cap iterations), then on
    each active lane stage 1 left unconverged the stage-2 restart from u0
    (lm_lambda_init x 10) and, with ``lm_stage3``, each pull-back of
    ``lm_stage3_pullbacks`` until one converges (lm_lambda_init), each rung
    with s2_budget and at most s2_cap iterations (csrc/lm.cuh).

    Arrays as ``lm_solve_kernel``'s. Returns (u1, chi2_1, conv1, it1, edm1,
    u2, chi2_2, conv2, it2, rung_lanes): stage 1's end, the rungs' merged
    end (zeros on lanes that entered none), and the lanes that entered each
    rung ([ladder_rungs(cfg)] int32, on the device). Bit-equal to
    ``lm_ladder_plain``."""
    if not u0.is_cuda:
        return lm_ladder_plain(cfg, coeffs_pad, x0, y, w, u0, lo, hi, p_seed,
                               param_mask, active, s1_cap, s1_budget, s2_cap,
                               s2_budget)
    u1, chi2_1, conv1, it1, edm1, _, *rest = _launch(
        cfg, coeffs_pad, x0, y, w, u0, lo, hi, p_seed, param_mask, active,
        s1_cap, cfg.lm_lambda_init, s1_budget, ladder=(s2_cap, s2_budget))
    return (u1, chi2_1, conv1, it1, edm1, *rest)

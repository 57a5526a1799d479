"""K5, K6 and K7: the generic LM loop's system evaluations (csrc/eval.cu).

Counterpart of npswf_tpu/fit/pallas_eval.py, whose three Pallas kernels
these replace:

- ``fused_eval`` (K5, ``_kernel``): the spline model f and the per-pulse
  Jacobian windows Jt, Ja over the fit bins;
- ``fused_neq`` (K7, ``_neq_kernel``): the normal equations A, g, chi2 from
  K5's outputs and dp/du, for P <= NARROW_P;
- ``fused_system`` (K6, ``_system_kernel``): transform, model, Jacobian
  columns and normal equations in one call.

Each wrapper takes CPU tensors to its plain PyTorch version (``*_plain``,
counted in ``kernels.plain_calls``); CUDA tensors launch the kernel or
raise. The plain versions round each op separately and sum over the fit
bins in bin order, the kernels' order, so that on the card the two agree
bit for bit. The module also holds the segment-plane layout (PAD, SEG,
``pad_coeffs``) and the sin bound transform the evaluations share.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.config import NPSConfig

# Copied from npswf_tpu/fit/pallas_eval.py (that module imports jax). Its
# KP fit-bin padding has no counterpart: the port loops over the real bins.
PAD = 16         # left padding of the segment planes (wrap margin)
SEG = 128        # padded segment-plane width: must exceed PAD + 109
NARROW_P = 4     # widest pulse count of the fused_neq route


def pad_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    """[N, S, 4] -> [N, 4, SEG] padded coefficient planes (copied from
    npswf_tpu/fit/pallas_eval.py::pad_coeffs)."""
    N, S, _ = coeffs.shape
    if S + PAD > SEG:
        raise ValueError(f"spline has {S} segments; SEG={SEG} fits at most "
                         f"{SEG - PAD} (PAD={PAD})")
    planes = coeffs.transpose(1, 2)                       # [N, 4, S]
    return F.pad(planes, (PAD, SEG - PAD - S)).contiguous()


# ---------------------------------------------------------------------
# the Minuit sin bound transform (npswf_tpu/fit/lm.py:92-110)
# ---------------------------------------------------------------------
def to_physical(u, lo, hi, p_seed, param_mask):
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    p = mid + half * torch.sin(u)
    return torch.where(param_mask & (half > 0), p, p_seed)


def dp_du(u, lo, hi, param_mask):
    half = 0.5 * (hi - lo)
    return torch.where(param_mask & (half > 0), half * torch.cos(u), 0.0)


# ---------------------------------------------------------------------
# plain versions (their bodies are uncounted so that K3's plain version,
# fit/lm_kernel.py::lm_solve_plain, can reuse them)
# ---------------------------------------------------------------------
def _eval(cfg: NPSConfig, coeffs_pad, x0, t_par, a_par, ped, pulse_mask):
    """For a pulse at time t, u = ceil(t + x0) - (t + x0) is constant across
    the fit bins and bin k reads slot (fit_lo_bin + PAD + k - ceil(t + x0))
    mod SEG."""
    N, P = t_par.shape
    K = cfg.nfitbins
    dtype = t_par.dtype
    k = torch.arange(K, device=t_par.device)
    xk = k.to(dtype) + cfg.fit_lo_bin
    f = ped[:, None].expand(N, K)
    jt, ja = [], []
    for p in range(P):
        tp = t_par[:, p:p + 1]                               # [N, 1]
        amp = a_par[:, p:p + 1]
        tau = tp + x0[:, None]
        ceil_t = torch.ceil(tau)
        uu = ceil_t - tau
        slot = torch.remainder(
            cfg.fit_lo_bin + PAD - ceil_t.long() + k[None, :], SEG)
        a, b, c, d = torch.gather(
            coeffs_pad, 2, slot[:, None, :].expand(N, 4, K)).unbind(1)
        sval = ((d * uu + c) * uu + b) * uu + a
        sder = (3.0 * d * uu + 2.0 * c) * uu + b
        rel = xk - tp
        gate = (rel > cfg.spline_gate_lo) & (rel < cfg.ntime - 1)
        actp = pulse_mask[:, p:p + 1].to(dtype)
        val = torch.where(gate, sval, 0.0) * actp
        der = torch.where(gate, sder, 0.0) * actp
        f = f + amp * val
        jt.append(-amp * der)
        ja.append(val)
    return f, torch.stack(jt, dim=1), torch.stack(ja, dim=1)


def _neq(y, w, f, jt, ja, dpdu):
    """A [N,M,M], g [N,M], chi2 [N], summed over the bins in bin order."""
    N, P, K = jt.shape
    M = 1 + 2 * P
    dtype, dev = y.dtype, y.device
    A = torch.zeros((N, M, M), dtype=dtype, device=dev)
    g = torch.zeros((N, M), dtype=dtype, device=dev)
    chi2 = torch.zeros((N,), dtype=dtype, device=dev)
    # weighted columns [N, M, K] in the (ped, t0, A0, ...) layout and the
    # weighted residual, each element rounded as the kernels round it
    jp = torch.stack([jt, ja], dim=2).reshape(N, 2 * P, K)
    cols = torch.cat([dpdu[:, :1, None] * w[:, None, :],
                      jp * dpdu[:, 1:, None] * w[:, None, :]], dim=1)
    r = (y - f) * w
    for k in range(K):
        c, rk = cols[:, :, k], r[:, k]
        A = A + c[:, :, None] * c[:, None, :]
        g = g + c * rk[:, None]
        chi2 = chi2 + rk * rk
    return A, g, chi2


def system_plain_body(cfg: NPSConfig, coeffs_pad, x0, y, w, u, lo, hi,
                      p_seed, param_mask):
    """fused_system's arithmetic, uncounted (K3's plain version uses it)."""
    p = to_physical(u, lo, hi, p_seed, param_mask)
    f, jt, ja = _eval(cfg, coeffs_pad, x0, p[:, 1::2], p[:, 2::2], p[:, 0],
                      param_mask[:, 2::2])
    return _neq(y, w, f, jt, ja, dp_du(u, lo, hi, param_mask))


def fused_eval_plain(cfg: NPSConfig, coeffs_pad, x0, t_par, a_par, ped,
                     pulse_mask):
    """The plain version of K5 (the body of the reference package's
    PallasSplineRefModel evaluation)."""
    kernels.plain_calls[kernels.FUSED_EVAL] += 1
    return _eval(cfg, coeffs_pad, x0, t_par, a_par, ped, pulse_mask)


def fused_neq_plain(cfg: NPSConfig, y, w, f, jt, ja, dpdu):
    """The plain version of K7."""
    kernels.plain_calls[kernels.FUSED_NEQ] += 1
    return _neq(y, w, f, jt, ja, dpdu)


def fused_system_plain(cfg: NPSConfig, coeffs_pad, x0, y, w, u, lo, hi,
                       p_seed, param_mask):
    """The plain version of K6."""
    kernels.plain_calls[kernels.FUSED_SYSTEM] += 1
    return system_plain_body(cfg, coeffs_pad, x0, y, w, u, lo, hi, p_seed,
                             param_mask)


# ---------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _tri_index(M: int, device: torch.device) -> torch.Tensor:
    """Row-major (i, j) -> packed upper-triangle position, [M * M]."""
    tri, pos = [[0] * M for _ in range(M)], 0
    for i in range(M):
        for j in range(i, M):
            tri[i][j] = tri[j][i] = pos
            pos += 1
    return torch.tensor([tri[i][j] for i in range(M) for j in range(M)],
                        device=device)


def _unpack(out: torch.Tensor, M: int):
    """[MT + M + 1, N] lanes-minor kernel output -> (A [N,M,M] symmetric,
    g [N,M], chi2 [N])."""
    N, MT = out.shape[1], M * (M + 1) // 2
    A = out.index_select(0, _tri_index(M, out.device)).t().reshape(N, M, M)
    return A, out[MT:MT + M].t(), out[MT + M]


def fused_eval(cfg: NPSConfig, coeffs_pad: torch.Tensor, x0: torch.Tensor,
               t_par: torch.Tensor, a_par: torch.Tensor, ped: torch.Tensor,
               pulse_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """coeffs_pad [N,4,SEG], x0/ped [N], t_par/a_par/pulse_mask [N,P] ->
    (f [N,K], Jt [N,P,K], Ja [N,P,K]) with K = cfg.nfitbins."""
    if not t_par.is_cuda:
        return fused_eval_plain(cfg, coeffs_pad, x0, t_par, a_par, ped,
                                pulse_mask)
    N, P = t_par.shape
    K = cfg.nfitbins
    dev, dt = t_par.device, t_par.dtype
    kernels.require(coeffs_pad, "coeffs_pad", (N, 4, SEG), dt, dev)
    kernels.require(x0, "x0", (N,), dt, dev)
    if tuple(pulse_mask.shape) != (N, P) or pulse_mask.device != dev:
        raise ValueError(f"pulse_mask must be [{N}, {P}] on {dev}")
    tp, ap = t_par.contiguous(), a_par.contiguous()
    kernels.require(ap, "a_par", (N, P), dt, dev)
    pd = ped.contiguous()
    kernels.require(pd, "ped", (N,), dt, dev)
    mask = pulse_mask.to(torch.uint8).contiguous()
    f = torch.empty((N, K), dtype=dt, device=dev)
    jt = torch.empty((N, P, K), dtype=dt, device=dev)
    ja = torch.empty((N, P, K), dtype=dt, device=dev)
    if N == 0:
        return f, jt, ja
    code = kernels.library().npswf_fused_eval(
        kernels.dtype_code(dt), coeffs_pad.data_ptr(), x0.data_ptr(),
        tp.data_ptr(), ap.data_ptr(), pd.data_ptr(), mask.data_ptr(),
        f.data_ptr(), jt.data_ptr(), ja.data_ptr(), N, P, K, cfg.fit_lo_bin,
        float(cfg.spline_gate_lo), float(cfg.ntime - 1),
        kernels.stream_ptr(dev))
    kernels.check(code, kernels.FUSED_EVAL)
    kernels.launches[kernels.FUSED_EVAL] += 1
    return f, jt, ja


def fused_neq(cfg: NPSConfig, y: torch.Tensor, w: torch.Tensor,
              f: torch.Tensor, jt: torch.Tensor, ja: torch.Tensor,
              dpdu: torch.Tensor):
    """y/w/f [N,K], jt/ja [N,P,K], dpdu [N,M] -> (A [N,M,M], g [N,M],
    chi2 [N]); P <= NARROW_P."""
    if not y.is_cuda:
        return fused_neq_plain(cfg, y, w, f, jt, ja, dpdu)
    N, P, K = jt.shape
    M = 1 + 2 * P
    dev, dt = y.device, y.dtype
    if not 1 <= P <= NARROW_P:
        raise ValueError(f"fused_neq kernel takes 1..{NARROW_P} pulses, not {P}")
    for name, t in (("y", y), ("w", w), ("f", f)):
        if tuple(t.shape) != (N, K) or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} must be [{N}, {K}] {dt} on {dev}")
    kernels.require(jt, "jt", (N, P, K), dt, dev)
    kernels.require(ja, "ja", (N, P, K), dt, dev)
    dpdu = dpdu.contiguous()
    kernels.require(dpdu, "dpdu", (N, M), dt, dev)
    out = torch.empty((M * (M + 1) // 2 + M + 1, N), dtype=dt, device=dev)
    if N == 0:
        return _unpack(out, M)
    # lanes-minor fit data: a warp's loads of one fit bin coalesce
    ins = (y.t().contiguous(), w.t().contiguous(), f.t().contiguous(), jt, ja,
           dpdu)
    ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    code = kernels.library().npswf_fused_neq(
        kernels.dtype_code(dt), P, ptrs, out.data_ptr(), N, K,
        kernels.stream_ptr(dev))
    kernels.check(code, kernels.FUSED_NEQ)
    kernels.launches[kernels.FUSED_NEQ] += 1
    return _unpack(out, M)


def fused_system(cfg: NPSConfig, coeffs_pad: torch.Tensor, x0: torch.Tensor,
                 y: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, p_seed: torch.Tensor,
                 param_mask: torch.Tensor):
    """coeffs_pad [N,4,SEG], x0 [N], y/w [N,K] (w = 1/sigma), u/lo/hi/
    p_seed/param_mask [N,M] -> (A [N,M,M], g [N,M], chi2 [N])."""
    if not u.is_cuda:
        return fused_system_plain(cfg, coeffs_pad, x0, y, w, u, lo, hi,
                                  p_seed, param_mask)
    N, M = u.shape
    P = (M - 1) // 2
    K = y.shape[1]
    dev, dt = u.device, u.dtype
    lib = kernels.library()
    if M != 1 + 2 * P or not lib.npswf_system_supported(P):
        raise ValueError(f"fused_system kernel has no instantiation for {P} "
                         f"pulses (M = {M})")
    kernels.require(coeffs_pad, "coeffs_pad", (N, 4, SEG), dt, dev)
    kernels.require(x0, "x0", (N,), dt, dev)
    u = u.contiguous()
    for name, t in (("u", u), ("lo", lo), ("hi", hi), ("p_seed", p_seed)):
        kernels.require(t, name, (N, M), dt, dev)
    for name, t in (("y", y), ("w", w)):
        if tuple(t.shape) != (N, K) or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} must be [{N}, {K}] {dt} on {dev}")
    if tuple(param_mask.shape) != (N, M):
        raise ValueError("param_mask must be [N, M]")
    out = torch.empty((M * (M + 1) // 2 + M + 1, N), dtype=dt, device=dev)
    if N == 0:
        return _unpack(out, M)
    ins = (coeffs_pad, x0, y.t().contiguous(), w.t().contiguous(), u, lo, hi,
           p_seed, param_mask.to(torch.uint8).contiguous())
    ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    code = lib.npswf_fused_system(
        kernels.dtype_code(dt), P, ptrs, out.data_ptr(), N, K, cfg.fit_lo_bin,
        float(cfg.spline_gate_lo), float(cfg.ntime - 1), kernels.stream_ptr(dev))
    kernels.check(code, kernels.FUSED_SYSTEM)
    kernels.launches[kernels.FUSED_SYSTEM] += 1
    return _unpack(out, M)

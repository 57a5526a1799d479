"""Frozen plain ``process_batch``: one event batch through the matched
filter, the TSpectrum-parity peak search, the 3x3 cluster gate, the bounded
LM fit with its retry ladder and the diagnostics, in plain PyTorch.

A copy of the port's plain path on its default route (the version each of
its CUDA kernels is held to bit for bit), taken from npswf_tpu_torch:
ops/matched_filter.py, ops/peak_search.py, ops/cluster_gate.py,
fit/errors.py, fit/linalg.py, fit/eval_kernel.py (``pad_coeffs``, the sin
transform, ``_eval``, ``_neq``), fit/lm.py (``lm_loop`` and the ladder) with
fit/lm_kernel.py::lm_solve_plain as the solve, engine/diagnostics.py and
engine/pipeline.py::process_batch. It runs one device, no block shards,
the ``spline_ref`` model, and refuses the flags of other routes.

``process_batch(g, cal, batch, dtype, device)`` takes the configuration's
fields (``spec.Geometry``), the generated calibration arrays (numpy) and
the batch (numpy signal [E, B, T], pres [E, B], corr [E], optional
minsignal [E, B]) and returns the outputs as numpy arrays by the names of
the port's ``PipelineOutput``. ``dtype`` is the compute type: the
configuration's, or one below it for the control.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

PAD = 16
SEG = 128
SAT_THRESH = 0.9995
CHOL_EPS = 1e-30
BINMIN = 30
BINMAX = 109
_NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
              (-1, -1))
# flags of routes the reference does not follow, with the value it follows
_ROUTE = dict(model_name="spline_ref", use_pallas_lm=True,
              use_fused_neq=False, use_fused_system=False,
              pallas_search_select=False)


# ----------------------------------------------------------------------
# matched filter
# ----------------------------------------------------------------------
def matched_filter(g, signal, minsignal, kern_rev, mfint):
    T, W, R = g.ntime, g.mfwidth, g.mfright
    lo, hi = g.mfleft, T - g.mfright
    n = hi - lo
    delta = signal - minsignal[:, None]
    inv = mfint[:, None]
    acc = torch.zeros(signal.shape[:-1] + (n,), dtype=signal.dtype,
                      device=signal.device)
    for jt in range(W):
        acc = acc + (delta[:, jt + lo - R: jt + lo - R + n]
                     * kern_rev[:, jt:jt + 1]) / inv
    acc = acc - acc.amin(dim=1, keepdim=True)
    out = torch.zeros_like(signal)
    out[:, lo:hi] = acc
    return out


# ----------------------------------------------------------------------
# peak search
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _static_response(sigma: float, size_ext: int):
    resp = np.zeros(size_ext)
    area = 0.0
    lh_gold = -1
    posit = 0
    mx = 0.0
    for i in range(size_ext):
        lda = (i - 3.0 * sigma) ** 2 / (2.0 * sigma * sigma)
        q = float(int(1000.0 * math.exp(-lda)))
        if q != 0.0:
            lh_gold = i + 1
        resp[i] = q
        area += q
        if q > mx:
            mx = q
            posit = i
    L = lh_gold - 1
    bvec = np.zeros(2 * L + 1)
    for lag in range(-L, L + 1):
        jmin = 0 if lag >= 0 else -lag
        jmax = min(L, L - lag)
        bvec[lag + L] = sum(resp[j] * resp[lag + j]
                            for j in range(jmin, jmax + 1))
    return resp[:lh_gold], area, lh_gold, posit, bvec


def search_geometry(g, ssize: int):
    shift = int(7.0 * g.spec_sigma + 0.5)
    size_ext = ssize + 2 * shift
    resp, area, lh_gold, posit, bvec = _static_response(g.spec_sigma, size_ext)
    return shift, size_ext, resp, area, lh_gold, posit, bvec


def extension_fit(g):
    kfit = int(2.0 * g.spec_sigma + 0.5)
    i_arr = np.arange(kfit, dtype=np.float64)
    m0, m1, m2 = float(kfit), float(i_arr.sum()), float((i_arr ** 2).sum())
    return kfit, m0, m1, m0 * m2 - m1 * m1


def _running_sums(x):
    out = torch.zeros((x.shape[0], x.shape[1] + 1), dtype=x.dtype,
                      device=x.device)
    acc = out[:, 0]
    for i in range(x.shape[1]):
        acc = acc + x[:, i]
        out[:, i + 1] = acc
    return out


def search_operands(g, src, aux, aux_offset: int):
    dtype, dev = src.dtype, src.device
    N, ssize = src.shape
    shift, size_ext, resp_np, area, lh_gold, posit, bvec_np = \
        search_geometry(g, ssize)
    L = lh_gold - 1

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    kfit, m0, m1, det = extension_fit(g)
    if kfit >= 2:
        nfit = min(kfit, ssize)
        l0 = _running_sums(src[:, :nfit])[:, -1]
        l1 = _running_sums(src[:, :nfit] * const(np.arange(nfit)))[:, -1]
        l1low = ((-l0 * m1 + l1 * m0) / const(det)) if det != 0.0 \
            else torch.zeros_like(l0)
        l1low = torch.clamp(l1low, max=0.0)
    else:
        l1low = torch.zeros((N,), dtype=dtype, device=dev)
    left_off = const(np.arange(shift) - shift)
    left = torch.clamp(src[:, :1] + l1low[:, None] * left_off, min=0.0)
    right = torch.clamp(src[:, -1:], min=0.0).expand(N, shift)
    ext = torch.cat([left, src, right], dim=1)

    maxch = ext.amax(dim=1, keepdim=True)
    plocha = _running_sums(ext)[:, -1:]
    y = ext / torch.where(maxch > 0, maxch, 1.0)
    nip, nim = y[:, :-1], y[:, 1:]
    sp = torch.zeros_like(nip)
    sm = torch.zeros_like(nip)
    xmax = size_ext - 1
    for l in range(1, g.spec_aver_window + 1):
        kf, kb = min(l, xmax), min(l - 1, xmax)
        a_f = torch.cat([y[:, kf:xmax], y[:, xmax:xmax + 1].expand(N, kf)],
                        dim=1)
        s_f = a_f + nip
        sp = sp + torch.exp((a_f - nip) / torch.where(s_f <= 0.0, 1.0,
                                                      torch.sqrt(s_f)))
        a_b = torch.cat([y[:, :1].expand(N, kb), y[:, :xmax - kb]], dim=1)
        s_b = a_b + nim
        sm = sm + torch.exp((a_b - nim) / torch.where(s_b <= 0.0, 1.0,
                                                      torch.sqrt(s_b)))
    logr = torch.log(sp) - torch.log(sm)
    logw = _running_sums(logr)
    w = torch.exp(logw - logw.amax(dim=1, keepdim=True))
    smoothed = w / _running_sums(w)[:, -1:] * plocha

    src_abs = smoothed.abs()
    padded = F.pad(src_abs, (L, 0))
    pvec = torch.zeros_like(src_abs)
    for j in range(lh_gold):
        pvec = pvec + float(resp_np[j]) * padded[:, j:j + size_ext]

    def _den(x):
        xp = F.pad(x, (L, L))
        d = torch.zeros_like(x)
        for j in range(2 * L + 1):
            d = d + float(bvec_np[j]) * xp[:, j:j + size_ext]
        return d

    x = torch.ones_like(src_abs)
    prev = torch.zeros_like(src_abs)
    for _ in range(g.spec_decon_iterations):
        den = _den(x)
        cond = (pvec.abs() > 1e-5) & (x.abs() > 1e-5)
        factor = torch.where((den != 0.0) & (pvec != 0.0),
                             pvec / torch.where(den == 0, 1.0, den), 0.0)
        prev = torch.where(cond, factor * x, prev)
        x = prev
    idx = np.arange(size_ext)
    in_range = torch.as_tensor(
        (idx >= shift) & (idx < ssize + shift) & (idx < size_ext - L),
        device=dev)
    decon = torch.where(in_range, area * torch.roll(x, posit - L, dims=1), 0.0)
    maximum_decon = decon.amax(dim=1, keepdim=True)
    maximum = torch.where(in_range, ext, -math.inf).amax(dim=1, keepdim=True)

    is_lmax = torch.zeros((N, size_ext), dtype=torch.bool, device=dev)
    is_lmax[:, 1:-1] = ((decon[:, 1:-1] > decon[:, :-2])
                        & (decon[:, 1:-1] > decon[:, 2:]))
    accept = (is_lmax & in_range
              & (decon > g.specthres * maximum_decon)
              & (ext > g.specthres * maximum)
              & (maxch > 0))
    dl = F.pad(decon, (1, 1))
    num = (const(idx - 1 - shift) * dl[:, :-2]
           + const(idx - shift) * dl[:, 1:-1]
           + const(idx + 1 - shift) * dl[:, 2:])
    den3 = dl[:, :-2] + dl[:, 1:-1] + dl[:, 2:]
    a = torch.clamp(num / torch.where(den3 == 0, 1.0, den3), 0.0,
                    float(ssize - 1))

    j_idx = torch.arange(size_ext, device=dev)

    def _window_select(arr, target, cands):
        pad_arr = F.pad(arr, (shift, size_ext - ssize - shift))
        k_val = target + shift
        out = pad_arr
        for c in cands:
            if c == 0:
                continue
            if c < 0:
                sh = F.pad(pad_arr, (-c, 0))[:, :c]
            else:
                sh = F.pad(pad_arr, (0, c))[:, c:]
            out = torch.where(k_val == j_idx + c, sh, out)
        return out

    a_int = torch.clamp(torch.floor(a).long(), 0, ssize - 1)
    key = _window_select(src, a_int, (-1, 0, 1))
    k_round = torch.clamp(torch.floor(a + 0.5).long(), 0, ssize - 1)
    pos_y_full = _window_select(src, k_round, (-1, 0, 1))
    tgt = torch.clamp(k_round + aux_offset, 0, ssize - 1)
    cands = tuple(range(min(0, aux_offset - 1), max(0, aux_offset + 1) + 1))
    aux_sel = _window_select(aux, tgt, cands)
    negkey = torch.where(accept, -key, math.inf)
    sl = slice(shift, shift + ssize)
    return negkey[:, sl], a[:, sl], pos_y_full[:, sl], aux_sel[:, sl]


def _select(operands, P: int):
    negkey, cent, pos_y, aux_sel = operands
    neg_srt, order = torch.sort(negkey, dim=1, stable=True)
    order = order[:, :P]
    return (neg_srt[:, :P], torch.gather(cent, 1, order),
            torch.gather(pos_y, 1, order), torch.gather(aux_sel, 1, order))


def find_pulses(g, signal, minsignal, kern_rev, mfint, present):
    T = g.ntime
    P = g.maxwfpulses
    mf = matched_filter(g, signal, minsignal, kern_rev, mfint)
    mf_search = mf.to(torch.float32).to(mf.dtype)
    neg, cent, pos_y, raw = _select(
        search_operands(g, mf_search, signal.to(mf_search.dtype), -1), P)
    valid = neg < math.inf
    pos_x = torch.where(valid, torch.floor(cent + 0.5) + 0.5, 0.0)
    pos_y = torch.where(valid, pos_y, 0.0)
    raw = torch.where(valid, raw, 0.0)
    xpos = pos_x - 2.0
    gate = (valid
            & (xpos > max(g.mfstart, 0))
            & (xpos < min(g.mfend, T - 1))
            & (pos_y > g.mfthres)
            & present[:, None])
    amp = torch.abs(raw - minsignal[:, None])
    order = torch.sort((~gate).to(torch.int32), dim=1, stable=True).indices
    times_c = torch.gather(torch.where(gate, xpos, 0.0), 1, order)
    amps_c = torch.gather(torch.where(gate, amp, 0.0), 1, order)
    valid_c = torch.gather(gate, 1, order)
    npulse = gate.sum(dim=1).to(torch.int32)
    return npulse, times_c, amps_c, valid_c


# ----------------------------------------------------------------------
# cluster gate
# ----------------------------------------------------------------------
def cluster_gate(g, signal, timeref, timerefacc):
    lead = signal.shape[:-2]
    T = g.ntime
    nrows = signal.shape[-2] // g.ncol
    grid = signal.reshape(lead + (nrows, g.ncol, T))
    padded = F.pad(grid, (0, 0, 1, 1, 1, 1))
    acc = grid
    for dr, dc in _NEIGHBORS:
        acc = acc + padded[..., 1 + dr:1 + dr + nrows,
                           1 + dc:1 + dc + g.ncol, :]
    s33 = acc.reshape(lead + (nrows * g.ncol, T))
    center = timeref + timerefacc
    it = torch.arange(g.ntime, dtype=signal.dtype, device=signal.device)
    in_window = torch.abs(it[None, :] - center[:, None]) < g.coinc_width
    gmin = s33.amin(dim=-1)
    wmax = torch.where(in_window, s33, -1e6).amax(dim=-1)
    return (wmax - gmin) > g.trig_thres


# ----------------------------------------------------------------------
# fit
# ----------------------------------------------------------------------
def error_model(g, y):
    s = g.err_scale
    e = torch.sqrt(torch.abs(y * s / 2.0)) / s
    floor = math.sqrt(abs(g.err_floor_input * s / 2.0)) / s
    return torch.where(e < 1.0, floor, e)


def cholesky_solve(A, b, eps: float = 1e-30):
    N, M, _ = A.shape
    idx = torch.arange(M, device=A.device)
    L = torch.zeros_like(A)
    S = A
    for j in range(M):
        d = torch.sqrt(torch.clamp(S[:, j, j], min=eps))
        col = torch.where(idx[None, :] >= j, S[:, :, j] / d[:, None], 0.0)
        L[:, :, j] = col
        S = S - col[:, :, None] * col[:, None, :]
    y = b.clone()
    for k in range(M):
        y[:, k] = y[:, k] / L[:, k, k]
        y[:, k + 1:] = y[:, k + 1:] - L[:, k + 1:, k] * y[:, k:k + 1]
    x = torch.zeros_like(b)
    for i in range(M - 1, -1, -1):
        acc = y[:, i]
        for k in range(i + 1, M):
            acc = acc - L[:, k, i] * x[:, k]
        x[:, i] = acc / L[:, i, i]
    return x


def pad_coeffs(coeffs):
    N, S, _ = coeffs.shape
    if S + PAD > SEG:
        raise ValueError(f"spline has {S} segments; SEG={SEG} fits at most "
                         f"{SEG - PAD}")
    planes = coeffs.transpose(1, 2)
    return F.pad(planes, (PAD, SEG - PAD - S)).contiguous()


def to_physical(u, lo, hi, p_seed, param_mask):
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    p = mid + half * torch.sin(u)
    return torch.where(param_mask & (half > 0), p, p_seed)


def dp_du(u, lo, hi, param_mask):
    half = 0.5 * (hi - lo)
    return torch.where(param_mask & (half > 0), half * torch.cos(u), 0.0)


def _eval(g, coeffs_pad, x0, t_par, a_par, ped, pulse_mask):
    N, P = t_par.shape
    K = g.nfitbins
    dtype = t_par.dtype
    k = torch.arange(K, device=t_par.device)
    xk = k.to(dtype) + g.fit_lo_bin
    f = ped[:, None].expand(N, K)
    jt, ja = [], []
    for p in range(P):
        tp = t_par[:, p:p + 1]
        amp = a_par[:, p:p + 1]
        tau = tp + x0[:, None]
        ceil_t = torch.ceil(tau)
        uu = ceil_t - tau
        slot = torch.remainder(
            g.fit_lo_bin + PAD - ceil_t.long() + k[None, :], SEG)
        a, b, c, d = torch.gather(
            coeffs_pad, 2, slot[:, None, :].expand(N, 4, K)).unbind(1)
        sval = ((d * uu + c) * uu + b) * uu + a
        sder = (3.0 * d * uu + 2.0 * c) * uu + b
        rel = xk - tp
        gate = (rel > g.spline_gate_lo) & (rel < g.ntime - 1)
        actp = pulse_mask[:, p:p + 1].to(dtype)
        val = torch.where(gate, sval, 0.0) * actp
        der = torch.where(gate, sder, 0.0) * actp
        f = f + amp * val
        jt.append(-amp * der)
        ja.append(val)
    return f, torch.stack(jt, dim=1), torch.stack(ja, dim=1)


def _neq(y, w, f, jt, ja, dpdu):
    N, P, K = jt.shape
    M = 1 + 2 * P
    dtype, dev = y.dtype, y.device
    A = torch.zeros((N, M, M), dtype=dtype, device=dev)
    gv = torch.zeros((N, M), dtype=dtype, device=dev)
    chi2 = torch.zeros((N,), dtype=dtype, device=dev)
    jp = torch.stack([jt, ja], dim=2).reshape(N, 2 * P, K)
    cols = torch.cat([dpdu[:, :1, None] * w[:, None, :],
                      jp * dpdu[:, 1:, None] * w[:, None, :]], dim=1)
    r = (y - f) * w
    for k in range(K):
        c, rk = cols[:, :, k], r[:, k]
        A = A + c[:, :, None] * c[:, None, :]
        gv = gv + c * rk[:, None]
        chi2 = chi2 + rk * rk
    return A, gv, chi2


def lm_loop(g, system, u0, lo, hi, param_mask, active, max_iter: int, lam0,
            iter_budget=None):
    dtype, dev = u0.dtype, u0.device
    N, M = u0.shape
    eye = torch.eye(M, dtype=dtype, device=dev)
    lam_down = torch.tensor(g.lm_lambda_down, dtype=dtype, device=dev)
    eps = float(torch.finfo(dtype).eps)
    ftol_eff = max(g.lm_ftol, 100.0 * eps)
    gtol_eff = max(g.lm_gtol, 100.0 * eps)

    def solve_damped(A, gv, lam):
        diag = torch.diagonal(A, dim1=1, dim2=2)
        scale = torch.where(diag > 1e-30, torch.sqrt(diag), 1.0)
        As = A / (scale[:, :, None] * scale[:, None, :])
        dead = diag <= 1e-30
        As = torch.where(dead[:, :, None] | dead[:, None, :], 0.0, As)
        damped = As * (1.0 - eye[None]) + eye[None] * (1.0 + lam[:, None, None])
        gs = torch.where(dead, 0.0, gv / scale)
        delta = cholesky_solve(damped, gs, CHOL_EPS) / scale
        return torch.where(dead, 0.0, delta)

    def gcrit_of(A, gv, chi2, u):
        diag = torch.diagonal(A, dim1=1, dim2=2)
        dead = diag <= 1e-30
        sinu = torch.sin(u)
        push = gv * dp_du(u, lo, hi, param_mask)
        kkt = (((sinu > SAT_THRESH) & (push > 0))
               | ((sinu < -SAT_THRESH) & (push < 0)))
        denom = (torch.sqrt(torch.where(dead, 1.0, diag))
                 * torch.sqrt(torch.clamp(chi2, min=eps))[:, None])
        return torch.amax(torch.where(dead | kkt, 0.0, torch.abs(gv)) / denom,
                          dim=1)

    if iter_budget is None:
        iter_budget = torch.full((N,), max_iter, dtype=torch.int32, device=dev)
    A, gv, chi2_0 = system(u0)
    u = u0
    chi2 = torch.where(active, chi2_0, 0.0)
    lam = torch.zeros((N,), dtype=dtype, device=dev) + lam0
    done = ~active | (iter_budget <= 0)
    conv = torch.zeros((N,), dtype=torch.bool, device=dev)
    n_iter = torch.zeros((N,), dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        gcrit = gcrit_of(A, gv, chi2, u)
        conv_g = gcrit < gtol_eff
        u_try = u + solve_damped(A, gv, lam)
        A_t, g_t, chi2_try = system(u_try)
        good = torch.isfinite(chi2_try) & (chi2_try < chi2)
        step = good & ~done & ~conv_g
        u = torch.where(step[:, None], u_try, u)
        A = torch.where(step[:, None, None], A_t, A)
        gv = torch.where(step[:, None], g_t, gv)
        chi2_new = torch.where(step, chi2_try, chi2)
        lam_new = torch.clamp(torch.where(step, lam / lam_down,
                                          lam * g.lm_lambda_up),
                              g.lm_lambda_min, g.lm_lambda_max)
        rel_impr = (chi2 - chi2_new) / torch.clamp(chi2, min=1.0)
        conv_f = step & (rel_impr < ftol_eff)
        conv_now = ~done & (conv_g | conv_f)
        n_iter = torch.where(done, n_iter, n_iter + 1)
        lam = torch.where(done, lam, lam_new)
        chi2 = chi2_new
        conv = conv | conv_now
        done = done | conv_now | (n_iter >= iter_budget)
    return u, chi2, conv & active, n_iter


def _interleave(first, t, a):
    inter = torch.stack([t, a], dim=-1).reshape(t.shape[0], -1)
    return torch.cat([first[:, None], inter], dim=1)


def fit_waveforms(g, inp: dict):
    """The escalated fit on the lanes of ``inp`` (y, sigma, coeffs, x0,
    t_seed, a_seed, ped_seed, pulse_mask, active): stage 1, the stage-2
    seed restart and the stage-3 pull-back rungs. Returns (params [N, M],
    chi2_ndf [N], converged [N], n_iter [N])."""
    y, pmask, active = inp["y"], inp["pulse_mask"], inp["active"]
    N = inp["t_seed"].shape[0]
    dtype = y.dtype
    a_lo = inp["a_seed"] * g.amp_lo_frac
    a_hi = inp["a_seed"] * g.amp_hi_frac
    ped = torch.full((N,), g.ped_limit, dtype=dtype, device=y.device)
    lo = _interleave(-ped, inp["t_seed"] - g.time_limit,
                     torch.minimum(a_lo, a_hi))
    hi = _interleave(ped, inp["t_seed"] + g.time_limit,
                     torch.maximum(a_lo, a_hi))
    p_seed = _interleave(torch.clamp(inp["ped_seed"], -g.ped_limit,
                                     g.ped_limit),
                         inp["t_seed"], inp["a_seed"])
    pm = torch.cat([torch.ones_like(pmask[:, :1]),
                    torch.repeat_interleave(pmask, 2, dim=1)], dim=1)
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    safe_half = torch.where(half > 0, half, 1.0)
    u0 = torch.where(pm & (half > 0),
                     torch.asin(torch.clamp((p_seed - mid) / safe_half,
                                            -1.0, 1.0)), 0.0)
    wide = pmask.sum(dim=1) > g.lm_wide_pulses
    s1_budget = torch.where(wide, g.lm_stage1_wide,
                            g.lm_max_iter_stage1).to(torch.int32)
    s2_budget = torch.where(wide, g.lm_stage2_wide,
                            g.lm_max_iter_stage2).to(torch.int32)
    s1_cap = max(g.lm_max_iter_stage1, g.lm_stage1_wide)
    s2_cap = max(g.lm_max_iter_stage2, g.lm_stage2_wide)
    w = 1.0 / inp["sigma"]
    coeffs_pad = pad_coeffs(inp["coeffs"])

    def solve(sel, start_u, mask, max_iter, lam0, budget):
        """One LM stage on the lanes ``sel`` (None: every lane)."""
        def take(a):
            return a if sel is None else a.index_select(0, sel)
        lo_s, hi_s, ps_s, pm_s = take(lo), take(hi), take(p_seed), take(pm)
        cp_s, x0_s, y_s, w_s = (take(coeffs_pad), take(inp["x0"]), take(y),
                                take(w))

        def system(u):
            p = to_physical(u, lo_s, hi_s, ps_s, pm_s)
            f, jt, ja = _eval(g, cp_s, x0_s, p[:, 1::2], p[:, 2::2], p[:, 0],
                              pm_s[:, 2::2])
            return _neq(y_s, w_s, f, jt, ja, dp_du(u, lo_s, hi_s, pm_s))
        return lm_loop(g, system, take(start_u), lo_s, hi_s, pm_s, take(mask),
                       max_iter, lam0, take(budget))

    u1, chi2_1, conv1, it1 = solve(None, u0, active, s1_cap,
                                   g.lm_lambda_init, s1_budget)

    def retry(mask, start_u, lam0):
        sel = torch.nonzero(mask).squeeze(1)
        u_c, chi2_c, conv_c, it_c = solve(sel, start_u, mask, s2_cap, lam0,
                                          s2_budget)
        return (torch.zeros_like(u1).index_copy(0, sel, u_c),
                torch.zeros_like(chi2_1).index_copy(0, sel, chi2_c),
                torch.zeros_like(conv1).index_copy(0, sel, conv_c),
                torch.zeros_like(it1).index_copy(0, sel, it_c))

    failed1 = active & ~conv1
    if bool(failed1.any()):
        u2, chi2_2, conv2, it2 = retry(failed1, u0, g.lm_lambda_init * 10.0)
    else:
        u2, chi2_2 = torch.zeros_like(u1), torch.zeros_like(chi2_1)
        conv2, it2 = torch.zeros_like(conv1), torch.zeros_like(it1)
    if g.lm_stage3:
        for pullback in g.lm_stage3_pullbacks:
            failed2 = failed1 & ~conv2
            if not bool(failed2.any()):
                break
            sinu1 = torch.sin(u1)
            sat = torch.abs(sinu1) > 0.95
            u_pb = torch.where(sat & pm,
                               torch.asin(float(pullback) * torch.sign(sinu1)),
                               u1)
            u3, chi2_3, conv3, it3 = retry(failed2, u_pb, g.lm_lambda_init)
            use3 = failed2 & conv3
            u2 = torch.where(use3[:, None], u3, u2)
            chi2_2 = torch.where(use3, chi2_3, chi2_2)
            conv2 = conv2 | use3
            it2 = it2 + torch.where(failed2, it3, 0)

    use2 = failed1 & conv2
    u = torch.where(use2[:, None], u2, u1)
    chi2 = torch.where(use2, chi2_2, chi2_1)
    converged = conv1 | use2
    params = to_physical(u, lo, hi, p_seed, pm)
    params = torch.where((active & ~converged)[:, None], p_seed, params)
    nfree = 1 + 2 * pmask.sum(dim=1)
    ndf = torch.clamp(y.shape[1] - nfree, min=1).to(dtype)
    return params, chi2 / ndf, converged, it1 + it2


# ----------------------------------------------------------------------
# diagnostics
# ----------------------------------------------------------------------
def block_diagnostics(g, signal):
    T = g.ntime
    dev = signal.device
    it = torch.arange(T, device=dev)
    in_win = (it > BINMIN) & (it < BINMAX)
    nwin = int(in_win.sum())
    nbkg = T - nwin
    integ = signal.sum(dim=-1)
    ener_raw = torch.where(in_win, signal, 0.0).sum(dim=-1)
    bkg_sum = torch.where(~in_win, signal, 0.0).sum(dim=-1)
    ener = ener_raw - bkg_sum * nwin / nbkg
    bkg = bkg_sum / nbkg
    dev2 = signal - bkg[..., None]
    noise = torch.sqrt(torch.where(~in_win, dev2 * dev2, 0.0).sum(dim=-1)
                       / nbkg)
    return {"ampl": signal.amax(dim=-1), "ener": ener, "integ": integ,
            "bkg": bkg, "noise": noise, "enertot": ener_raw.sum(dim=-1),
            "integtot": integ.sum(dim=-1)}


# ----------------------------------------------------------------------
# one batch
# ----------------------------------------------------------------------
def check_route(g) -> None:
    for k, v in _ROUTE.items():
        if getattr(g, k) != v:
            raise ValueError(f"the reference follows {k} = {v!r}, the "
                             f"configuration states {getattr(g, k)!r}")


def process_batch(g, cal: Dict[str, np.ndarray], signal: np.ndarray,
                  pres: np.ndarray, corr: np.ndarray, dtype: torch.dtype,
                  device, minsignal: Optional[np.ndarray] = None
                  ) -> Dict[str, np.ndarray]:
    check_route(g)
    dev = torch.device(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)
    with torch.no_grad():
        sig = t(signal)
        E, B, T = sig.shape
        P = g.maxwfpulses
        N = E * B
        timeref = t(cal["timeref"])
        cortime = t(cal["cortime"])
        timerefacc = t(np.float64(cal["timerefacc"]))
        coeffs = t(cal["spline_coeffs"])
        x0 = t(cal["spline_x0"])
        kern = t(cal["mfkern_rev"])
        mfint = t(cal["mfint"])
        preswf = torch.as_tensor(np.asarray(cal["preswf"], bool), device=dev)
        present = torch.as_tensor(np.asarray(pres, bool), device=dev) \
            & preswf[None, :]
        flat_sig = sig.reshape(N, T)
        flat_present = present.reshape(N)
        minsig = (t(minsignal).reshape(N) if minsignal is not None
                  else flat_sig.amin(dim=1))
        kern_flat = kern[None].expand(E, B, g.mfwidth).reshape(N, -1)
        mfint_flat = mfint[None].expand(E, B).reshape(N)
        searched = flat_present
        if g.search_capacity and g.search_capacity < N:
            # the first search_capacity present lanes in lane order are
            # searched; a present lane past them reads as no pulse
            searched = flat_present & (
                torch.cumsum(flat_present.to(torch.int64), 0)
                <= g.search_capacity)
        npulse, seed_t_abs, seed_a, pulse_mask = find_pulses(
            g, flat_sig, minsig, kern_flat, mfint_flat, searched)

        gate = cluster_gate(g, sig, timeref, timerefacc).reshape(N)
        fit_active = flat_present & gate & (npulse > 0)

        M = 1 + 2 * P
        Ps = max(1, min(g.fit_small_pulses, P))
        if g.fit_capacity and g.fit_capacity < N:
            raise ValueError("the reference fits every lane (fit_capacity 0)")
        blocks_flat = torch.arange(B, device=dev).repeat(E)
        ped_seed_all = flat_sig[:, :g.ped_nsamples].mean(dim=1)
        params = torch.zeros((N, M), dtype=dtype, device=dev)
        chi2_ndf = torch.zeros((N,), dtype=dtype, device=dev)
        converged = torch.zeros((N,), dtype=torch.bool, device=dev)
        n_iter_lanes = torch.zeros((N,), dtype=torch.int32, device=dev)
        fitted = torch.zeros((N,), dtype=torch.bool, device=dev)
        small = fit_active & (npulse <= Ps)
        big = fit_active & (npulse > Ps)
        buckets = [(small, Ps)]
        if P > Ps:
            Pm = min(g.fit_mid_pulses, P)
            if Pm > Ps:
                buckets.append((big & (npulse <= Pm), Pm))
                big = big & (npulse > Pm)
            buckets.append((big, P))
        for mask, Pb in buckets:
            if int(mask.sum()) == 0:
                continue
            sel_err = error_model(g, flat_sig)
            inp = dict(
                y=flat_sig[:, g.fit_lo_bin:g.fit_hi_bin],
                sigma=sel_err[:, g.fit_lo_bin:g.fit_hi_bin],
                coeffs=coeffs[blocks_flat], x0=x0[blocks_flat],
                t_seed=seed_t_abs[:, :Pb] - timeref[blocks_flat][:, None],
                a_seed=seed_a[:, :Pb], ped_seed=ped_seed_all,
                pulse_mask=pulse_mask[:, :Pb], active=mask)
            pf, c2, cv, it = fit_waveforms(g, inp)
            pf = torch.cat([pf, torch.zeros((N, 2 * (P - Pb)), dtype=dtype,
                                            device=dev)], dim=1)
            params = torch.where(mask[:, None], pf, params)
            chi2_ndf = torch.where(mask, c2, chi2_ndf)
            converged = converged | (cv & mask)
            n_iter_lanes = torch.where(mask, it, n_iter_lanes)
            fitted = fitted | mask

        cortime_b = cortime[blocks_flat]
        corrv = t(corr).repeat_interleave(B)
        t_param = params[:, 1::2]
        a_param = params[:, 2::2]
        seed_t_rel = seed_t_abs - timeref[blocks_flat][:, None]
        t_rel = torch.where(fitted[:, None], t_param, seed_t_rel)
        a_fin = torch.where((fitted & converged)[:, None], a_param, seed_a)
        pedwf = torch.where(fitted, params[:, 0], ped_seed_all)
        conv_term = (corrv - cortime_b - timerefacc * g.dt)[:, None]
        t_ns = t_rel * g.dt + conv_term
        wftime = torch.where(pulse_mask,
                             torch.where(fitted[:, None], t_ns, seed_t_abs),
                             0.0)
        wfampl = torch.where(pulse_mask, a_fin, 0.0)
        chi2 = torch.where(fitted & converged, chi2_ndf, -100.0)
        abs_t = torch.where(pulse_mask, torch.abs(wftime), float("inf"))
        best = torch.argmin(abs_t, dim=1, keepdim=True)
        has = fitted & (npulse > 0)
        timewf = torch.where(has, torch.gather(wftime, 1, best)[:, 0], -100.0)
        amplwf = torch.where(has, torch.gather(wfampl, 1, best)[:, 0], -100.0)
        h_mask = fitted[:, None] & pulse_mask & (wfampl > g.amp_h12_thres)
        h1 = t_rel - timerefacc + corrv[:, None] / g.dt
        diag = block_diagnostics(g, sig)
        out = dict(
            wfnpulse=npulse.reshape(E, B), wftime=wftime.reshape(E, B, P),
            wfampl=wfampl.reshape(E, B, P),
            pulse_valid=pulse_mask.reshape(E, B, P), chi2=chi2.reshape(E, B),
            timewf=timewf.reshape(E, B), amplwf=amplwf.reshape(E, B),
            pedwf=pedwf.reshape(E, B), gate=gate.reshape(E, B),
            fit_converged=(fitted & converged).reshape(E, B),
            fit_n_iter=torch.where(fitted, n_iter_lanes, 0).reshape(E, B),
            h1time=h1.reshape(E, B, P), h2time=wftime.reshape(E, B, P),
            h_mask=h_mask.reshape(E, B, P), **diag)
        return {k: v.cpu().numpy() if v.dtype != torch.bfloat16
                else v.float().cpu().numpy() for k, v in out.items()}

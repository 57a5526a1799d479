"""Markov-smoothed peak search (TSpectrum::Search parity) and find_pulses.

Counterpart of npswf_tpu/ops/peak_search.py (ref TEST_2.C:186-207): for
sigma=2, "nobackground,nodraw", threshold 0.02, 3 deconvolution iterations,
Markov smoothing with averWindow 3:

1. extend the T-bin spectrum by shift = int(7*sigma+0.5) bins each side
   (left: clamped straight-line extrapolation, right: constant);
2. Markov smoothing in log space with max-subtraction;
3. Gold deconvolution against the integer-quantized Gaussian response;
4. accept local maxima above specthres * max(decon) whose source value also
   exceeds specthres * max(source); 3-bin centroid;
5. top-``maxwfpulses`` by source amplitude, ties in bin order (a stable
   sort, TSpectrum's insertion order).

``search_operands`` (steps 1-4 and the four sort operands) is the plain
version of the K2 kernel and ``search_topk`` (the same, then the first P
slots of step 5) that of the K4 kernel (both in ops/search_kernel.py);
``tspectrum_search`` and ``find_pulses`` run K2 then the sort, or K4 under
``pallas_search_select``, unless ``plain=True``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.ops.matched_filter import matched_filter
from npswf_tpu_torch.ops.mf_kernel import matched_filter_kernel


# Copied from npswf_tpu/ops/peak_search.py::_static_response (that module
# imports jax).
@functools.lru_cache(maxsize=8)
def _static_response(sigma: float, size_ext: int):
    """Quantized Gaussian response, its area/extent/argmax and autocorrelation."""
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
        bvec[lag + L] = sum(resp[j] * resp[lag + j] for j in range(jmin, jmax + 1))
    return resp[:lh_gold], area, lh_gold, posit, bvec


def search_geometry(cfg: NPSConfig, ssize: int):
    """(shift, size_ext, resp, area, lh_gold, posit, bvec) of the search."""
    shift = int(7.0 * cfg.spec_sigma + 0.5)
    size_ext = ssize + 2 * shift
    resp, area, lh_gold, posit, bvec = _static_response(cfg.spec_sigma, size_ext)
    return shift, size_ext, resp, area, lh_gold, posit, bvec


def extension_fit(cfg: NPSConfig):
    """(kfit, m0, m1, det) of the left straight-line extrapolation."""
    kfit = int(2.0 * cfg.spec_sigma + 0.5)
    i_arr = np.arange(kfit, dtype=np.float64)
    m0, m1, m2 = float(kfit), float(i_arr.sum()), float((i_arr ** 2).sum())
    return kfit, m0, m1, m0 * m2 - m1 * m1


def _running_sums(x: torch.Tensor) -> torch.Tensor:
    """[N, n] -> [N, n+1]: 0 followed by the running sums of the columns,
    accumulated column by column (the sequential order of the K2 kernel;
    torch.sum and torch.cumsum on the card reduce as trees and scans)."""
    out = torch.zeros((x.shape[0], x.shape[1] + 1), dtype=x.dtype,
                      device=x.device)
    acc = out[:, 0]
    for i in range(x.shape[1]):
        acc = acc + x[:, i]
        out[:, i + 1] = acc
    return out


def search_operands(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
                    aux_offset: int):
    """The four top-P sort operands, each [N, T] in the source-bin frame:
    negkey (-amplitude on accepted peaks, +inf elsewhere), centroid, pos_y
    (source at the rounded centroid) and aux at round(centroid) + aux_offset
    (the XLA path of npswf_tpu/ops/peak_search.py:124-297)."""
    kernels.count_plain(kernels.SEARCH_OPERANDS)
    return _operands(cfg, src, aux, aux_offset)


def search_topk(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
                aux_offset: int, P: int):
    """The plain version of K4: the sort operands, then the first P slots
    of their stable sort on negkey (descending amplitude, ties in bin
    order), each [N, P]. Slots past a lane's accepted peaks hold negkey
    +inf; their other values are masked by the caller."""
    kernels.count_plain(kernels.SEARCH_TOPK)
    return _select(_operands(cfg, src, aux, aux_offset), P)


def _select(operands, P: int):
    negkey, cent, pos_y, aux_sel = operands
    neg_srt, order = torch.sort(negkey, dim=1, stable=True)
    order = order[:, :P]
    return (neg_srt[:, :P], torch.gather(cent, 1, order),
            torch.gather(pos_y, 1, order), torch.gather(aux_sel, 1, order))


def _operands(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
              aux_offset: int):
    dtype, dev = src.dtype, src.device
    N, ssize = src.shape
    shift, size_ext, resp_np, area, lh_gold, posit, bvec_np = \
        search_geometry(cfg, ssize)
    L = lh_gold - 1

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- 1. extension -------------------------------------------------
    kfit, m0, m1, det = extension_fit(cfg)
    if kfit >= 2:
        # the fit's sums over the bins that exist (kfit passes T from sigma
        # 54.75 on at T = 110; the JAX kernel masks, its XLA path raises),
        # its moments over kfit
        nfit = min(kfit, ssize)
        l0 = _running_sums(src[:, :nfit])[:, -1]
        l1 = _running_sums(src[:, :nfit] * const(np.arange(nfit)))[:, -1]
        # det as a device tensor: PyTorch's CUDA division by a CPU scalar
        # multiplies by its reciprocal, which rounds unlike the kernel's
        l1low = ((-l0 * m1 + l1 * m0) / const(det)) if det != 0.0 \
            else torch.zeros_like(l0)
        l1low = torch.clamp(l1low, max=0.0)
    else:
        l1low = torch.zeros((N,), dtype=dtype, device=dev)
    left_off = const(np.arange(shift) - shift)
    left = torch.clamp(src[:, :1] + l1low[:, None] * left_off, min=0.0)
    right = torch.clamp(src[:, -1:], min=0.0).expand(N, shift)
    ext = torch.cat([left, src, right], dim=1)                     # [N, size_ext]

    # ---- 2. Markov smoothing (log space, scale-invariant) -------------
    maxch = ext.amax(dim=1, keepdim=True)
    plocha = _running_sums(ext)[:, -1:]
    y = ext / torch.where(maxch > 0, maxch, 1.0)
    nip, nim = y[:, :-1], y[:, 1:]
    sp = torch.zeros_like(nip)
    sm = torch.zeros_like(nip)
    xmax = size_ext - 1
    for l in range(1, cfg.spec_aver_window + 1):
        # neighbours y[min(i+l, xmax)] and y[max(i-l+1, 0)], for windows
        # past the frame too (TSpectrum clamps; the JAX package's slices
        # stop at l = xmax)
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

    # ---- 3. Gold deconvolution ---------------------------------------
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
    for _ in range(cfg.spec_decon_iterations):
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
    # decon[e] = area * x[e + L - posit]: the response-argmax shift and the
    # padding realignment compose into one circular roll
    decon = torch.where(in_range, area * torch.roll(x, posit - L, dims=1), 0.0)
    maximum_decon = decon.amax(dim=1, keepdim=True)
    maximum = torch.where(in_range, ext, -math.inf).amax(dim=1, keepdim=True)

    # ---- 4. accept + centroid ----------------------------------------
    is_lmax = torch.zeros((N, size_ext), dtype=torch.bool, device=dev)
    is_lmax[:, 1:-1] = ((decon[:, 1:-1] > decon[:, :-2])
                        & (decon[:, 1:-1] > decon[:, 2:]))
    accept = (is_lmax & in_range
              & (decon > cfg.specthres * maximum_decon)
              & (ext > cfg.specthres * maximum)
              & (maxch > 0))
    dl = F.pad(decon, (1, 1))
    num = (const(idx - 1 - shift) * dl[:, :-2]
           + const(idx - shift) * dl[:, 1:-1]
           + const(idx + 1 - shift) * dl[:, 2:])
    den3 = dl[:, :-2] + dl[:, 1:-1] + dl[:, 2:]
    a = torch.clamp(num / torch.where(den3 == 0, 1.0, den3), 0.0,
                    float(ssize - 1))

    # ---- 5. window selects + sort operands ---------------------------
    # The centroid lies within +-1 bin of its local max, so arr[target] is
    # a select among static shifts of arr (rejected bins are masked anyway).
    j_idx = torch.arange(size_ext, device=dev)

    def _window_select(arr, target, cands):
        pad_arr = F.pad(arr, (shift, size_ext - ssize - shift))
        k_val = target + shift
        out = pad_arr
        for c in cands:
            if c == 0:
                continue
            if c < 0:
                sh = F.pad(pad_arr, (-c, 0))[:, :c]              # arr[j + c]
            else:
                sh = F.pad(pad_arr, (0, c))[:, c:]
            out = torch.where(k_val == j_idx + c, sh, out)
        return out

    a_int = torch.clamp(torch.floor(a).long(), 0, ssize - 1)
    key = _window_select(src, a_int, (-1, 0, 1))
    k_round = torch.clamp(torch.floor(a + 0.5).long(), 0, ssize - 1)
    pos_y_full = _window_select(src, k_round, (-1, 0, 1))
    tgt = torch.clamp(k_round + aux_offset, 0, ssize - 1)
    # reachable offsets: every c between min(0, o-1) and max(0, o+1)
    cands = tuple(range(min(0, aux_offset - 1), max(0, aux_offset + 1) + 1))
    aux_sel = _window_select(aux, tgt, cands)
    negkey = torch.where(accept, -key, math.inf)
    sl = slice(shift, shift + ssize)
    return negkey[:, sl], a[:, sl], pos_y_full[:, sl], aux_sel[:, sl]


def tspectrum_search(cfg: NPSConfig, src: torch.Tensor,
                     aux: torch.Tensor = None, aux_offset: int = 0,
                     plain: bool = False):
    """Batched peak search over ``src`` [N, T].

    Returns (pos_x [N,P], pos_y [N,P], valid [N,P]) with P =
    cfg.maxwfpulses, ordered by descending source amplitude; pos_x follows
    the Search() bin convention (k + 0.5); invalid slots hold zeros. With
    ``aux`` [N, T], a fourth output [N, P] samples it at
    clip(round(centroid) + aux_offset, 0, T-1).
    """
    from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                                   search_topk_kernel)
    P = cfg.maxwfpulses
    aux_in = (src if aux is None else aux).to(src.dtype)
    if cfg.pallas_search_select:
        run = search_topk if plain else search_topk_kernel
        neg, cent, pos_y, aux_sel = run(cfg, src, aux_in, aux_offset, P)
    else:
        run = search_operands if plain else search_operands_kernel
        neg, cent, pos_y, aux_sel = _select(run(cfg, src, aux_in, aux_offset), P)
    valid = neg < math.inf
    pos_x = torch.where(valid, torch.floor(cent + 0.5) + 0.5, 0.0)
    pos_y = torch.where(valid, pos_y, 0.0)
    if aux is not None:
        return pos_x, pos_y, valid, torch.where(valid, aux_sel, 0.0)
    return pos_x, pos_y, valid


class PulseSearchResult(NamedTuple):
    npulse: torch.Tensor   # [N] int32 — accepted pulse count
    times: torch.Tensor    # [N, P] — xpos in sample units (bin - 2 shift applied)
    amps: torch.Tensor     # [N, P] — |raw[round(xpos)] - minsignal| seed amplitude
    valid: torch.Tensor    # [N, P] bool — slot validity (compacted to the front)
    mf: torch.Tensor       # [N, T] — matched-filter output (diagnostics)


def find_pulses(cfg: NPSConfig, signal: torch.Tensor, minsignal: torch.Tensor,
                kern_rev: torch.Tensor, mfint: torch.Tensor,
                present: torch.Tensor, plain: bool = False) -> PulseSearchResult:
    """FindPulsesMF parity over flat lanes.

    signal [N, T]; minsignal [N]; kern_rev [N, W] reversed unnormalized
    kernel; mfint [N] per-tap divisor; present [N] bool (pres && preswf).
    """
    T = cfg.ntime
    mf_fn = matched_filter if plain else matched_filter_kernel
    mf = mf_fn(cfg, signal, minsignal, kern_rev, mfint)
    # the reference stores the filter in a float32-binned TH1F (ref :173-179)
    mf_search = mf.to(torch.float32).to(mf.dtype)
    # seed amplitude reads the RAW signal at floor(xpos + 0.5) = k_round - 1
    pos_x, pos_y, valid, raw = tspectrum_search(
        cfg, mf_search, aux=signal, aux_offset=-1, plain=plain)
    xpos = pos_x - 2.0                                   # -2 bin shift (ref :194)
    gate = (valid
            & (xpos > max(cfg.mfstart, 0))
            & (xpos < min(cfg.mfend, T - 1))
            & (pos_y > cfg.mfthres)
            & present[:, None])
    amp = torch.abs(raw - minsignal[:, None])
    # stable compaction: accepted slots first, in amplitude-descending order
    order = torch.sort((~gate).to(torch.int32), dim=1, stable=True).indices
    times_c = torch.gather(torch.where(gate, xpos, 0.0), 1, order)
    amps_c = torch.gather(torch.where(gate, amp, 0.0), 1, order)
    valid_c = torch.gather(gate, 1, order)
    npulse = gate.sum(dim=1).to(torch.int32)
    return PulseSearchResult(npulse=npulse, times=times_c, amps=amps_c,
                             valid=valid_c, mf=mf)

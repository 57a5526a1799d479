"""Derived per-block diagnostics.

Counterpart of npswf_tpu/engine/diagnostics.py (ref TEST_2.C:1026-1112):
window integrals and energies, background mean and RMS noise, the pulse
maximum (first occurrence), 50%/90% widths with the reference's scan
semantics, and the event totals. Computed for every block, present or not,
as the reference's unconditional block loop does.
"""
from __future__ import annotations

from typing import Dict

import torch

from npswf_tpu_torch.core.config import NPSConfig

BINMIN = 30   # cosmic-pulse window (ref :1029-1030)
BINMAX = 109


def block_diagnostics(cfg: NPSConfig, signal: torch.Tensor) -> Dict[str, torch.Tensor]:
    """signal [..., B, T] -> dict of [..., B] diagnostics (+ [...] totals;
    ``ener_raw``, the window sums before the background, is what
    ``enertot`` adds up)."""
    T = cfg.ntime
    dev = signal.device
    it = torch.arange(T, device=dev)
    in_win = (it > BINMIN) & (it < BINMAX)
    nwin = len(range(BINMIN + 1, min(BINMAX, T)))  # in_win's count, no sync
    nbkg = T - nwin

    integ = signal.sum(dim=-1)
    ener_raw = torch.where(in_win, signal, 0.0).sum(dim=-1)
    bkg_sum = torch.where(~in_win, signal, 0.0).sum(dim=-1)
    # ener -= bkg_sum * nwin / nbkg, THEN bkg becomes the mean (ref :1061-1063)
    ener = ener_raw - bkg_sum * nwin / nbkg
    bkg = bkg_sum / nbkg
    dev2 = signal - bkg[..., None]
    noise = torch.sqrt(torch.where(~in_win, dev2 * dev2, 0.0).sum(dim=-1) / nbkg)

    # pulse maximum: strict > scan keeps the FIRST occurrence (ref :1051-1057)
    tmax = torch.argmax(signal, dim=-1)
    sigmax = signal.amax(dim=-1)
    ampl = sigmax
    ampl2 = ampl - bkg

    rel = signal - bkg[..., None]
    c50 = rel >= ampl2[..., None] * 0.5
    c90 = rel >= ampl2[..., None] * 0.1
    itb = it.expand(signal.shape)
    right_m = itb >= tmax[..., None]
    left_m = itb <= tmax[..., None]
    # defaults when no bin qualifies (ref :1078-1081)
    max50 = torch.where(right_m & c50, itb, 0).amax(dim=-1)
    max90 = torch.where(right_m & c90, itb, 50).amax(dim=-1)
    min50 = torch.where(left_m & c50, itb, 100).amin(dim=-1)
    min90 = torch.where(left_m & c90, itb, 100).amin(dim=-1)

    return {
        "integ": integ, "ener": ener, "bkg": bkg, "noise": noise,
        "sigmax": sigmax, "ampl": ampl, "ampl2": ampl2,
        "time": tmax.to(signal.dtype),
        "larg50": (max50 - min50).to(signal.dtype),
        "larg90": (max90 - min90).to(signal.dtype),
        "ener_raw": ener_raw,
        "enertot": ener_raw.sum(dim=-1),
        "integtot": integ.sum(dim=-1),
    }

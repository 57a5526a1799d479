"""Waveform model family (spline reference model).

Counterpart of npswf_tpu/models/waveform.py: the reference's fit model
(ref TEST_2.C:621-635)

    f(x; p) = p0 + sum_n A_n * ref(x - t_n),   contribute iff 1 < x - t_n < 109

with ref() the block's cubic-spline reference waveform, evaluated with its
analytic Jacobian in the physical parameter layout
``p = [ped, t_0, A_0, t_1, A_1, ...]``. Two evaluations of the same model:
``spline_ref`` selects segments by gather (ops/spline.py); ``spline_ref_pallas``
reads the padded segment planes (``coeffs_pad``) the way the K3 kernel does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from npswf_tpu.core.config import NPSConfig
from npswf_tpu_torch.ops.spline import spline_eval_grad

# Copied from npswf_tpu/fit/pallas_eval.py (that module imports jax). Its
# KP fit-bin padding has no counterpart: the port loops over the real bins.
PAD = 16         # left padding of the segment planes (wrap margin)
SEG = 128        # padded segment-plane width: must exceed PAD + 109


def pad_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    """[N, S, 4] -> [N, 4, SEG] padded coefficient planes (copied from
    npswf_tpu/fit/pallas_eval.py::pad_coeffs)."""
    N, S, _ = coeffs.shape
    if S + PAD > SEG:
        raise ValueError(f"spline has {S} segments; SEG={SEG} fits at most "
                         f"{SEG - PAD} (PAD={PAD})")
    planes = coeffs.transpose(1, 2)                       # [N, 4, S]
    return F.pad(planes, (PAD, SEG - PAD - S)).contiguous()


def _interleave_jac(ped_col: torch.Tensor, jt, ja) -> torch.Tensor:
    """[N,K], P x [N,K], P x [N,K] -> J [N, K, 1+2P] in (ped, t0, A0, ...)."""
    cols = [ped_col]
    for t_col, a_col in zip(jt, ja):
        cols += [t_col, a_col]
    return torch.stack(cols, dim=-1)


class WaveformModel:
    """Protocol: batched model evaluation + analytic Jacobian."""

    name: str = "base"

    def prepare_aux(self, cfg: NPSConfig,
                    aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return aux

    def eval_and_jac(self, cfg: NPSConfig, params: torch.Tensor,
                     aux: Dict[str, torch.Tensor], xgrid: torch.Tensor,
                     pulse_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """params [N, M] -> (f [N, K], J [N, K, M])."""
        raise NotImplementedError


class SplineRefModel(WaveformModel):
    """Pedestal + sum of spline-interpolated reference pulses; ``aux``
    carries ``coeffs`` [N, S, 4] and ``x0`` [N]."""

    name = "spline_ref"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask):
        coeffs, x0 = aux["coeffs"], aux["x0"]
        N, M = params.shape
        P = (M - 1) // 2
        K = xgrid.shape[0]
        tpar = params[:, 1::2]
        apar = params[:, 2::2]
        arg = xgrid[None, None, :] - tpar[:, :, None]           # [N, P, K]
        val, dval = spline_eval_grad(cfg, coeffs, x0, arg.reshape(N, P * K))
        val = val.reshape(N, P, K)
        dval = dval.reshape(N, P, K)
        act = pulse_mask[:, :, None].to(params.dtype)
        f = params[:, :1] + torch.sum(act * apar[:, :, None] * val, dim=1)
        jt = -act * apar[:, :, None] * dval
        ja = act * val
        J = _interleave_jac(torch.ones_like(f), jt.unbind(1), ja.unbind(1))
        return f, J


class SplineRefPlanesModel(WaveformModel):
    """The same model read from the padded segment planes: for a pulse at
    time t, u = ceil(t + x0) - (t + x0) is constant across the fit bins and
    bin x reads slot (x - ceil(t + x0) + PAD) mod SEG. This is the
    evaluation the K3 kernel runs; it assumes xgrid = [fit_lo_bin,
    fit_hi_bin), the only grid the pipeline fits."""

    name = "spline_ref_pallas"

    def prepare_aux(self, cfg, aux):
        out = dict(aux)
        if "coeffs_pad" not in out:
            out["coeffs_pad"] = pad_coeffs(aux["coeffs"])
        return out

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask):
        coeffs_pad, x0 = aux["coeffs_pad"], aux["x0"]
        N, M = params.shape
        P = (M - 1) // 2
        K = xgrid.shape[0]
        dtype = params.dtype
        k = torch.arange(K, device=params.device)
        xk = k.to(dtype) + cfg.fit_lo_bin
        f = params[:, :1].expand(N, K)
        jt, ja = [], []
        for p in range(P):
            t_par = params[:, 1 + 2 * p:2 + 2 * p]              # [N, 1]
            amp = params[:, 2 + 2 * p:3 + 2 * p]
            tau = t_par + x0[:, None]
            ceil_t = torch.ceil(tau)
            uu = ceil_t - tau
            slot = torch.remainder(
                cfg.fit_lo_bin + PAD - ceil_t.long() + k[None, :], SEG)
            a, b, c, d = torch.gather(
                coeffs_pad, 2, slot[:, None, :].expand(N, 4, K)).unbind(1)
            sval = ((d * uu + c) * uu + b) * uu + a
            sder = (3.0 * d * uu + 2.0 * c) * uu + b
            rel = xk - t_par
            gate = (rel > cfg.spline_gate_lo) & (rel < cfg.ntime - 1)
            actp = pulse_mask[:, p:p + 1].to(dtype)
            val = torch.where(gate, sval, 0.0) * actp
            der = torch.where(gate, sder, 0.0) * actp
            f = f + amp * val
            jt.append(-amp * der)
            ja.append(val)
        J = _interleave_jac(torch.ones_like(f), jt, ja)
        return f, J


_REGISTRY: Dict[str, WaveformModel] = {}
_NOT_PORTED = ("gaussian", "biexp")


def register_model(model: WaveformModel) -> WaveformModel:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> WaveformModel:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue 1: the "
            "gaussian and biexp models)")
    return _REGISTRY[name]


register_model(SplineRefModel())
register_model(SplineRefPlanesModel())

"""Waveform model family (spline reference model).

Counterpart of npswf_tpu/models/waveform.py: the reference's fit model
(ref TEST_2.C:621-635)

    f(x; p) = p0 + sum_n A_n * ref(x - t_n),   contribute iff 1 < x - t_n < 109

with ref() the block's cubic-spline reference waveform, evaluated with its
analytic Jacobian in the physical parameter layout
``p = [ped, t_0, A_0, t_1, A_1, ...]``. Two evaluations of the same model:
``spline_ref`` selects segments by gather (ops/spline.py); ``spline_ref_pallas``
reads the padded segment planes (``coeffs_pad``) through the K5 kernel
(fit/eval_kernel.py), the evaluation K3 runs inside its loop.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.fit.eval_kernel import (fused_eval, fused_eval_plain,
                                             pad_coeffs)
from npswf_tpu_torch.ops.spline import spline_eval_grad


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
                     pulse_mask: torch.Tensor, plain: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """params [N, M] -> (f [N, K], J [N, K, M]); ``plain`` runs the
        plain version of any kernel the evaluation uses."""
        raise NotImplementedError


class SplineRefModel(WaveformModel):
    """Pedestal + sum of spline-interpolated reference pulses; ``aux``
    carries ``coeffs`` [N, S, 4] and ``x0`` [N]."""

    name = "spline_ref"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask, plain=False):
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
    """The same model read from the padded segment planes by K5
    (``fused_eval``): for a pulse at time t, u = ceil(t + x0) - (t + x0) is
    constant across the fit bins and bin x reads slot (x - ceil(t + x0) +
    PAD) mod SEG. It assumes xgrid = [fit_lo_bin, fit_hi_bin), the only grid
    the pipeline fits."""

    name = "spline_ref_pallas"

    def prepare_aux(self, cfg, aux):
        out = dict(aux)
        if "coeffs_pad" not in out:
            out["coeffs_pad"] = pad_coeffs(aux["coeffs"])
        return out

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask, plain=False):
        run = fused_eval_plain if plain else fused_eval
        f, jt, ja = run(cfg, aux["coeffs_pad"], aux["x0"], params[:, 1::2],
                        params[:, 2::2], params[:, 0], pulse_mask)
        J = _interleave_jac(torch.ones_like(f), jt.unbind(1), ja.unbind(1))
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

"""Waveform model families.

Counterpart of npswf_tpu/models/waveform.py: the reference's fit model
(ref TEST_2.C:621-635)

    f(x; p) = p0 + sum_n A_n * ref(x - t_n),   contribute iff 1 < x - t_n < 109

with ref() the block's cubic-spline reference waveform, evaluated with its
analytic Jacobian in the physical parameter layout
``p = [ped, t_0, A_0, t_1, A_1, ...]``. Two evaluations of the same model:
``spline_ref`` selects segments by gather (ops/spline.py); ``spline_ref_pallas``
reads the padded segment planes (``coeffs_pad``) through the K5 kernel
(fit/eval_kernel.py), the evaluation K3 runs inside its loop. Two other
pulse shapes, ``gaussian`` and ``biexp``, are plain PyTorch (the reference
package computes them outside any kernel too); the generic LM loop fits
them, with their shape constants from ``NPSConfig.model_aux``.
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


class GaussianPulseModel(WaveformModel):
    """Pedestal + sum of Gaussians of fixed width: ``aux['width']`` [N] is
    the per-lane sigma in bins. Times are relative to ``aux['timeref']``
    when the engine gives one (FitInputs.timeref), absolute otherwise."""

    name = "gaussian"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask, plain=False):
        w = aux["width"][:, None, None]                 # [N, 1, 1]
        center = aux.get("timeref")
        c = 0.0 if center is None else center[:, None, None]
        tpar = params[:, 1::2][:, :, None] + c          # [N, P, 1] absolute
        apar = params[:, 2::2][:, :, None]
        act = pulse_mask[:, :, None].to(params.dtype)
        z = (xgrid[None, None, :] - tpar) / w           # [N, P, K]
        val = torch.exp(-0.5 * z * z)
        dval = val * z / w                              # d/dt exp(-(x-t)^2/2w^2)
        f = params[:, :1] + torch.sum(act * apar * val, dim=1)
        J = _interleave_jac(torch.ones_like(f), (act * apar * dval).unbind(1),
                            (act * val).unbind(1))
        return f, J


class BiexpPulseModel(WaveformModel):
    """Normalized difference of two exponentials,
    s(v) = norm * (exp(-v/tau_d) - exp(-v/tau_r)) for v > 0, else 0, with v
    the time since the pulse's onset. t_n is the pulse's PEAK time and norm
    makes the peak 1, so amplitudes mean what they mean in the other
    families. ``aux['tau_r']``/``aux['tau_d']`` [N] are the rise and decay
    constants in bins (tau_d > tau_r)."""

    name = "biexp"

    def eval_and_jac(self, cfg, params, aux, xgrid, pulse_mask, plain=False):
        tr = aux["tau_r"][:, None, None]                # [N, 1, 1]
        td = aux["tau_d"][:, None, None]
        center = aux.get("timeref")
        c = 0.0 if center is None else center[:, None, None]
        tpar = params[:, 1::2][:, :, None] + c          # [N, P, 1] absolute peak
        apar = params[:, 2::2][:, :, None]
        act = pulse_mask[:, :, None].to(params.dtype)
        # the peak sits ustar after the onset; norm makes it 1
        ustar = torch.log(td / tr) * tr * td / (td - tr)
        norm = 1.0 / (torch.exp(-ustar / td) - torch.exp(-ustar / tr))
        v = xgrid[None, None, :] - tpar + ustar         # time since onset
        pos = v > 0
        vs = torch.where(pos, v, 0.0)                   # exp-safe gating
        ed = torch.exp(-vs / td)
        er = torch.exp(-vs / tr)
        val = torch.where(pos, norm * (ed - er), 0.0)
        dvdv = torch.where(pos, norm * (er / tr - ed / td), 0.0)  # d val / dv
        f = params[:, :1] + torch.sum(act * apar * val, dim=1)
        # v = x - t + ustar, so d f / d t = -A * d val / d v
        J = _interleave_jac(torch.ones_like(f), (-act * apar * dvdv).unbind(1),
                            (act * val).unbind(1))
        return f, J


_REGISTRY: Dict[str, WaveformModel] = {}


def register_model(model: WaveformModel) -> WaveformModel:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> WaveformModel:
    return _REGISTRY[name]


register_model(SplineRefModel())
register_model(SplineRefPlanesModel())
register_model(GaussianPulseModel())
register_model(BiexpPulseModel())

"""K2 and K4 wrappers: the peak search on the card (csrc/search.cu).

Replaces npswf_tpu/ops/pallas_search.py::_search_kernel in operands mode
(K2, ``search_operands_pallas``) and in select mode (K4,
``search_topk_pallas``). CPU tensors go to the plain versions,
``ops.peak_search.search_operands`` and ``ops.peak_search.search_topk``;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.ops.peak_search import (extension_fit, search_geometry,
                                             search_operands, search_topk)

# the kernel frame's margin rows (kMarg in csrc/search.cu)
MARGIN = 16


def _launch(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
            aux_offset: int, select_p: int, name: str):
    """One search kernel launch; returns its four outputs, each [N, rows]
    (rows = T, or P in select mode)."""
    N, ssize = src.shape
    dev, dt = src.device, src.dtype
    kernels.require(src, "src", (N, ssize), dt, dev)
    kernels.require(aux, "aux", (N, ssize), dt, dev)
    shift, size_ext, resp, area, lh_gold, posit, bvec = \
        search_geometry(cfg, ssize)
    # The frame margins bound the Gold correlation reach and the Markov
    # window: wider settings would read past a lane's frame, so refuse them.
    if lh_gold - 1 > MARGIN or cfg.spec_aver_window > MARGIN:
        raise ValueError(
            f"search kernel supports lh_gold-1 <= {MARGIN} and "
            f"spec_aver_window <= {MARGIN}; got lh_gold-1 = {lh_gold - 1} "
            f"(spec_sigma={cfg.spec_sigma}) and spec_aver_window = "
            f"{cfg.spec_aver_window}")
    if ssize < 1 or cfg.spec_aver_window < 1:
        raise ValueError("search kernel needs T >= 1 and spec_aver_window >= 1")
    rows = select_p if select_p else ssize
    outs = [torch.empty((N, rows), dtype=dt, device=dev) for _ in range(4)]
    if N == 0:
        return tuple(outs)
    # resp and bvec travel by value in the launch's parameters: no copy to
    # the card, no host sync
    resp_h = np.ascontiguousarray(resp, dtype=np.float64)
    bvec_h = np.ascontiguousarray(bvec, dtype=np.float64)
    kfit, m0, m1, det = extension_fit(cfg)
    code = kernels.library().npswf_search(
        kernels.dtype_code(dt), src.data_ptr(), aux.data_ptr(),
        *(o.data_ptr() for o in outs), N, ssize, shift, kfit, lh_gold, posit,
        cfg.spec_aver_window, cfg.spec_decon_iterations, aux_offset, select_p,
        m0, m1, det, float(area), float(cfg.specthres), resp_h.ctypes.data,
        bvec_h.ctypes.data, kernels.stream_ptr(dev))
    kernels.check(code, name)
    kernels.count_launch(name)
    return tuple(outs)


def search_operands_kernel(cfg: NPSConfig, src: torch.Tensor,
                           aux: torch.Tensor, aux_offset: int):
    """src/aux [N, T] -> (negkey, cent, pos_y, aux_sel), each [N, T]; the
    same contract as ``search_operands``."""
    if not src.is_cuda:
        return search_operands(cfg, src, aux, aux_offset)
    return _launch(cfg, src, aux, aux_offset, 0, kernels.SEARCH_OPERANDS)


def search_topk_kernel(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
                       aux_offset: int, P: int):
    """src/aux [N, T] -> (negkey, cent, pos_y, aux_sel), each [N, P] in
    slot order; the same contract as ``search_topk``, on every slot."""
    if not src.is_cuda:
        return search_topk(cfg, src, aux, aux_offset, P)
    if P < 1:
        raise ValueError(f"search_topk needs P >= 1, not {P}")
    return _launch(cfg, src, aux, aux_offset, P, kernels.SEARCH_TOPK)

"""K2 and K4 wrappers: the peak search on the card (csrc/search.cu).

Replaces npswf_tpu/ops/pallas_search.py::_search_kernel in operands mode
(K2, ``search_operands_pallas``) and in select mode (K4,
``search_topk_pallas``). CPU tensors go to the plain versions,
``ops.peak_search.search_operands`` and ``ops.peak_search.search_topk``;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.ops.peak_search import (extension_fit, search_geometry,
                                             search_operands, search_topk)

# the kernel frame's margin rows (kMarg in csrc/search.cu)
MARGIN = 16


def _launch(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
            aux_offset: int, select_p: int, name: str):
    """One search kernel launch; returns its four outputs as [N, rows]
    views of the lanes-minor [rows, N] tensors it writes (rows = T, or P in
    select mode)."""
    N, ssize = src.shape
    dev, dt = src.device, src.dtype
    kernels.require(aux, "aux", (N, ssize), dt, dev)
    shift, size_ext, resp, area, lh_gold, posit, bvec = \
        search_geometry(cfg, ssize)
    # The frame margins bound the Gold correlation reach and the Markov
    # window: wider settings would read another lane's rows, so refuse them.
    if lh_gold - 1 > MARGIN or cfg.spec_aver_window > MARGIN:
        raise ValueError(
            f"search kernel supports lh_gold-1 <= {MARGIN} and "
            f"spec_aver_window <= {MARGIN}; got lh_gold-1 = {lh_gold - 1} "
            f"(spec_sigma={cfg.spec_sigma}) and spec_aver_window = "
            f"{cfg.spec_aver_window}")
    if ssize < 1 or cfg.spec_aver_window < 1:
        raise ValueError("search kernel needs T >= 1 and spec_aver_window >= 1")
    rows = select_p if select_p else ssize
    outs = [torch.empty((rows, N), dtype=dt, device=dev) for _ in range(4)]
    if N == 0:
        return tuple(o.t() for o in outs)
    lib = kernels.library()
    src_t = src.t().contiguous()
    aux_t = aux.t().contiguous()
    resp_t = torch.as_tensor(resp, dtype=dt, device=dev)
    bvec_t = torch.as_tensor(bvec, dtype=dt, device=dev)
    scratch = torch.empty((lib.npswf_search_scratch_rows(size_ext), N),
                          dtype=dt, device=dev)
    kfit, m0, m1, det = extension_fit(cfg)
    code = lib.npswf_search(
        kernels.dtype_code(dt), src_t.data_ptr(), aux_t.data_ptr(),
        resp_t.data_ptr(), bvec_t.data_ptr(), scratch.data_ptr(),
        *(o.data_ptr() for o in outs), N, ssize, shift, kfit, lh_gold, posit,
        cfg.spec_aver_window, cfg.spec_decon_iterations, aux_offset, select_p,
        m0, m1, det, float(area), float(cfg.specthres), kernels.stream_ptr(dev))
    kernels.check(code, name)
    kernels.launches[name] += 1
    return tuple(o.t() for o in outs)


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
    slot order; the same contract as ``search_topk``."""
    if not src.is_cuda:
        return search_topk(cfg, src, aux, aux_offset, P)
    if P < 1:
        raise ValueError(f"search_topk needs P >= 1, not {P}")
    return _launch(cfg, src, aux, aux_offset, P, kernels.SEARCH_TOPK)

"""K2 and K4 wrappers: the peak search on the card (csrc/search.cu).

Replaces npswf_tpu/ops/pallas_search.py::_search_kernel in operands mode
(K2, ``search_operands_pallas``) and in select mode (K4,
``search_topk_pallas``). CPU tensors go to the plain versions,
``ops.peak_search.search_operands`` and ``ops.peak_search.search_topk``;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.ops.peak_search import (extension_fit, search_geometry,
                                             search_operands, search_topk)

# the most response taps (lh_gold) the kernel takes (kMaxResp in
# csrc/search.cu: they travel by value in the launch's parameters)
MAX_TAPS = 128


def search_max_reach(cfg: NPSConfig, T: int, dtype: torch.dtype,
                     device=None) -> Tuple[int, int]:
    """(largest lh_gold - 1, largest spec_aver_window) K2 and K4 take over
    T bins at ``cfg.spec_sigma``'s shift and ``dtype`` on ``device``
    (default the current card): a lane's frames, whose margins hold the
    Gold reach and the Markov window, must fit one block's shared memory
    with seven other lanes (csrc/search.cu). At T = 110 and sigma = 2 on
    an NVIDIA H100 80GB HBM3: 127 (the tap cap, MAX_TAPS - 1) and a
    window of 1,088 bins in fp32, 480 in fp64. Asked of the card once a
    (card, dtype, T, shift)."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    margin = _max_margin(index, dtype, int(T), search_geometry(cfg, T)[0])
    return min(margin, MAX_TAPS - 1), margin


@functools.lru_cache(maxsize=None)
def _max_margin(index: int, dtype: torch.dtype, T: int, shift: int) -> int:
    with torch.cuda.device(index):
        return int(kernels.library().npswf_search_max_reach(
            kernels.dtype_code(dtype), T, shift))


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
    if ssize < 1 or cfg.spec_aver_window < 1:
        raise ValueError("search kernel needs T >= 1 and spec_aver_window >= 1")
    # A lane's frame margins hold the Gold correlation reach and the Markov
    # window; beyond what a block's shared memory holds, refuse.
    max_lag, max_window = search_max_reach(cfg, ssize, dt, dev)
    if lh_gold - 1 > max_lag or cfg.spec_aver_window > max_window:
        raise ValueError(
            f"search kernel at T = {ssize}, shift = {shift}, {dt} takes "
            f"lh_gold-1 <= {max_lag} and spec_aver_window <= {max_window} "
            f"(search_max_reach); got lh_gold-1 = {lh_gold - 1} "
            f"(spec_sigma={cfg.spec_sigma}) and spec_aver_window = "
            f"{cfg.spec_aver_window}")
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

"""K2 and K4 wrappers: the peak search on the card (csrc/search.cu).

Replaces npswf_tpu/ops/pallas_search.py::_search_kernel in operands mode
(K2, ``search_operands_pallas``) and in select mode (K4,
``search_topk_pallas``). CPU tensors go to the plain versions,
``ops.peak_search.search_operands`` and ``ops.peak_search.search_topk``;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools
import numpy as np
import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.ops.peak_search import (extension_fit, search_geometry,
                                             search_operands, search_topk)


def search_layout(cfg: NPSConfig, T: int, dtype: torch.dtype) -> int:
    """The lanes a block of K2/K4 over T bins at ``cfg``'s sigma and
    Markov window in ``dtype`` on the current card (csrc/search.cu,
    plan_search): 8 at every default setting; fewer, one by one down to 1,
    as the frames that hold the Gold reach and the window grow; 0 past what
    one lane's frames take of a block's shared memory, which the kernel
    refuses (at T = 110 on an H100: sigma above 277 in fp64, 561 in fp32;
    a window above 4,720 bins at sigma 2 in fp64, 9,560 in fp32)."""
    shift, _, _, _, lh_gold, _, _ = search_geometry(cfg, T)
    return int(kernels.library().npswf_search_layout(
        kernels.dtype_code(dtype), int(T), shift, lh_gold,
        cfg.spec_aver_window))


@functools.lru_cache(maxsize=None)
def _taps(sigma: float, T: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """The Gold taps on the card, resp then bvec in ``dtype`` (rounded to
    nearest from fp64, as the plain version's constants are): copied once
    a (setting, card, type), and kept for the process."""
    cfg = NPSConfig(spec_sigma=sigma)
    _, _, resp, _, _, _, bvec = search_geometry(cfg, T)
    host = np.concatenate([np.asarray(resp, np.float64),
                           np.asarray(bvec, np.float64)])
    taps = torch.as_tensor(host, device=device).to(dtype)
    # other streams (the segment executor's two workers) read it from now on
    torch.cuda.current_stream(device).synchronize()
    kernels.count("sync.ops.search_taps")
    return taps


def _launch(cfg: NPSConfig, src: torch.Tensor, aux: torch.Tensor,
            aux_offset: int, select_p: int, name: str):
    """One search kernel launch; returns its four outputs, each [N, rows]
    (rows = T, or P in select mode)."""
    N, ssize = src.shape
    dev, dt = src.device, src.dtype
    kernels.require(src, "src", (N, ssize), dt, dev)
    kernels.require(aux, "aux", (N, ssize), dt, dev)
    shift, _, _, area, lh_gold, posit, _ = search_geometry(cfg, ssize)
    if ssize < 1 or cfg.spec_aver_window < 1:
        raise ValueError("search kernel needs T >= 1 and spec_aver_window >= 1")
    if search_layout(cfg, ssize, dt) == 0:
        raise ValueError(
            f"search kernel: one lane's frames at T = {ssize}, spec_sigma = "
            f"{cfg.spec_sigma} (lh_gold-1 = {lh_gold - 1}) and "
            f"spec_aver_window = {cfg.spec_aver_window} in {dt} do not fit a "
            f"block's shared memory")
    rows = select_p if select_p else ssize
    outs = [torch.empty((N, rows), dtype=dt, device=dev) for _ in range(4)]
    if N == 0:
        return tuple(outs)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    taps = _taps(float(cfg.spec_sigma), ssize, dt, torch.device("cuda", index))
    kfit, m0, m1, det = extension_fit(cfg)
    code = kernels.library().npswf_search(
        kernels.dtype_code(dt), src.data_ptr(), aux.data_ptr(),
        taps.data_ptr(),
        *(o.data_ptr() for o in outs), N, ssize, shift, kfit, lh_gold, posit,
        cfg.spec_aver_window, cfg.spec_decon_iterations, aux_offset, select_p,
        m0, m1, det, float(area), float(cfg.specthres),
        kernels.stream_ptr(dev))
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

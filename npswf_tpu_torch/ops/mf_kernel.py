"""K1 wrapper: the matched filter on the card (csrc/matched_filter.cu).

Replaces npswf_tpu/ops/pallas_kernels.py::_mf_kernel (wrapper
``matched_filter_pallas``). CPU tensors go to the plain version,
ops/matched_filter.py; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch import kernels
from npswf_tpu_torch.ops.matched_filter import matched_filter


def matched_filter_kernel(cfg: NPSConfig, signal: torch.Tensor,
                          minsignal: torch.Tensor, kern_rev: torch.Tensor,
                          mfint: torch.Tensor) -> torch.Tensor:
    """signal [N, T], minsignal [N], kern_rev [N, W], mfint [N] -> [N, T];
    the same contract and accumulation order as ``matched_filter``."""
    if not signal.is_cuda:
        return matched_filter(cfg, signal, minsignal, kern_rev, mfint)
    N, T = signal.shape
    if T != cfg.ntime:
        raise ValueError(f"signal has {T} samples, cfg.ntime is {cfg.ntime}")
    W = cfg.mfwidth
    dev, dt = signal.device, signal.dtype
    kernels.require(signal, "signal", (N, T), dt, dev)
    kernels.require(minsignal, "minsignal", (N,), dt, dev)
    kernels.require(kern_rev, "kern_rev", (N, W), dt, dev)
    kernels.require(mfint, "mfint", (N,), dt, dev)
    out = torch.empty_like(signal)
    if N == 0:
        return out
    lib = kernels.library()
    code = lib.npswf_matched_filter(
        kernels.dtype_code(dt), signal.data_ptr(), minsignal.data_ptr(),
        kern_rev.data_ptr(), mfint.data_ptr(), out.data_ptr(), N, T, W,
        cfg.mfleft, T - cfg.mfright, cfg.mfright, kernels.stream_ptr(dev))
    kernels.check(code, kernels.MATCHED_FILTER)
    kernels.count_launch(kernels.MATCHED_FILTER)
    return out

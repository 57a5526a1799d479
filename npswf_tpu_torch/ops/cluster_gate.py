"""Batched 3x3 cluster trigger gate (single device).

Counterpart of npswf_tpu/ops/cluster_gate.py (PassClusterThreshold, ref
TEST_2.C:218-278): each block's waveform summed with its 8 grid neighbours
(absent blocks are zero-filled), in the reference's neighbour order for fp
parity; a block passes iff the maximum of that sum inside the
+-coinc_width window around (timeref + timerefacc) minus the sum's global
minimum exceeds trig_thres.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from npswf_tpu.core.config import NPSConfig

# neighbour order as in ref TEST_2.C:247-248 (dR, dC)
_NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def _single_device(block_axis, block_shards) -> None:
    if block_axis is not None or block_shards > 1:
        raise NotImplementedError(
            "block-row sharding (halo exchange) is not ported yet: the "
            "torch.distributed mesh is in ROADMAP Queue 1")


def cluster_sums(cfg: NPSConfig, signal: torch.Tensor,
                 block_axis: Optional[str] = None,
                 block_shards: int = 1) -> torch.Tensor:
    """3x3 neighbourhood sums. signal [..., B, T] -> [..., B, T]."""
    _single_device(block_axis, block_shards)
    lead = signal.shape[:-2]
    T = cfg.ntime
    nrows = signal.shape[-2] // cfg.ncol
    grid = signal.reshape(lead + (nrows, cfg.ncol, T))
    padded = F.pad(grid, (0, 0, 1, 1, 1, 1))
    acc = grid
    for dr, dc in _NEIGHBORS:
        acc = acc + padded[..., 1 + dr:1 + dr + nrows,
                           1 + dc:1 + dc + cfg.ncol, :]
    return acc.reshape(lead + (nrows * cfg.ncol, T))


def cluster_gate(cfg: NPSConfig, signal: torch.Tensor, timeref: torch.Tensor,
                 timerefacc, block_axis: Optional[str] = None,
                 block_shards: int = 1) -> torch.Tensor:
    """Gate decision per block. signal [..., B, T] -> bool [..., B];
    timeref [B] is the per-block reference-max bin."""
    s33 = cluster_sums(cfg, signal, block_axis, block_shards)
    center = timeref + timerefacc                                  # [B]
    it = torch.arange(cfg.ntime, dtype=signal.dtype, device=signal.device)
    in_window = torch.abs(it[None, :] - center[:, None]) < cfg.coinc_width
    gmin = s33.amin(dim=-1)
    # the reference inits maxInWindow = -1e6 (ref :239, 269-272)
    wmax = torch.where(in_window, s33, -1e6).amax(dim=-1)
    return (wmax - gmin) > cfg.trig_thres

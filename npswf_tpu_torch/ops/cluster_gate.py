"""Batched 3x3 cluster trigger gate.

Counterpart of npswf_tpu/ops/cluster_gate.py (PassClusterThreshold, ref
TEST_2.C:218-278): each block's waveform summed with its 8 grid neighbours
(absent blocks are zero-filled), in the reference's neighbour order for fp
parity; a block passes iff the maximum of that sum inside the
+-coinc_width window around (timeref + timerefacc) minus the sum's global
minimum exceeds trig_thres.

When the calorimeter rows are split into block shards (a mesh's block
axis, ``parallel.mesh``), the one-row halos are exchanged within the block
group: a shard's last row becomes the next shard's top halo and its first
row the previous shard's bottom halo; the edge shards get zeros, the
out-of-grid neighbours' zero contribution. The halo rows take the place of
the zero pad and the sum's order is unchanged, so every shard's sums are
those one device computes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.parallel.axis import Axis, require_axis

# neighbour order as in ref TEST_2.C:247-248 (dR, dC)
_NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def _halo_rows(grid: torch.Tensor, block_axis: Axis):
    """(top, bottom) halo rows of this shard's [..., rows, ncol, T] grid:
    the previous shard's last row and the next shard's first, zeros at the
    edges of the calorimeter. One all-gather of every shard's first and
    last rows within the block group."""
    ends = torch.stack([grid[..., 0, :, :], grid[..., -1, :, :]])
    parts = block_axis.all_gather(ends)
    b, n = block_axis.index, block_axis.size
    zero = torch.zeros_like(ends[0])
    top = parts[b - 1][1] if b > 0 else zero
    bottom = parts[b + 1][0] if b < n - 1 else zero
    return top.unsqueeze(-3), bottom.unsqueeze(-3)


def cluster_sums(cfg: NPSConfig, signal: torch.Tensor,
                 block_axis: Optional[Axis] = None,
                 block_shards: int = 1) -> torch.Tensor:
    """3x3 neighbourhood sums. signal [..., B, T] -> [..., B, T], B the
    blocks of this shard; ``block_axis`` is the block group when the rows
    are split into ``block_shards`` shards."""
    lead = signal.shape[:-2]
    T = cfg.ntime
    nrows = signal.shape[-2] // cfg.ncol
    grid = signal.reshape(lead + (nrows, cfg.ncol, T))
    if block_shards > 1:
        require_axis(block_axis, f"cluster_sums over {block_shards} block "
                                 f"shards: block_axis")
        if block_axis.size != block_shards:
            raise ValueError(f"block_axis has {block_axis.size} shards, "
                             f"block_shards says {block_shards}")
        top, bottom = _halo_rows(grid, block_axis)
        padded = F.pad(torch.cat([top, grid, bottom], dim=-3),
                       (0, 0, 1, 1, 0, 0))
    else:
        padded = F.pad(grid, (0, 0, 1, 1, 1, 1))
    acc = grid
    for dr, dc in _NEIGHBORS:
        acc = acc + padded[..., 1 + dr:1 + dr + nrows,
                           1 + dc:1 + dc + cfg.ncol, :]
    return acc.reshape(lead + (nrows * cfg.ncol, T))


def cluster_gate(cfg: NPSConfig, signal: torch.Tensor, timeref: torch.Tensor,
                 timerefacc, block_axis: Optional[Axis] = None,
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

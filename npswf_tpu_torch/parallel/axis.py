"""One axis of a device mesh, as seen from inside one of its ranks.

The JAX package names a mesh axis by a string inside ``shard_map`` and its
collectives (``lax.psum``, ``lax.ppermute``) find the devices; here an
``Axis`` carries the ``torch.distributed`` process group of the ranks that
share this rank's other mesh coordinates, this rank's index along the axis
and the axis' size. ``process_batch`` and ``cluster_sums`` take ``Axis``
objects where the JAX functions take axis names.

Collectives on CUDA tensors go through the backend directly under NCCL.
Under gloo, which has no CUDA path for every collective, a CUDA tensor is
staged: copied to the host, reduced or gathered there, and copied back to
its device. The compute stays on the device either way; only the few bytes
a collective moves take the detour.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class Axis:
    """A mesh axis inside a rank: ``group`` (a process group, or None for
    the world), this rank's ``index`` along it, and its ``size``."""

    def __init__(self, name: str, group, index: int, size: int, backend: str):
        self.name = name
        self.group = group
        self.index = index
        self.size = size
        self.backend = backend

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis' ranks, on ``t``'s device."""
        x = t.cpu() if self._staged(t) else t.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x.to(t.device)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` of every rank of the axis, in axis order, on ``t``'s
        device (every rank gives a tensor of the same shape and type)."""
        x = (t.cpu() if self._staged(t) else t).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return [p.to(t.device) for p in parts]


def require_axis(arg, what: str) -> None:
    """Raise unless ``arg`` is an Axis (the JAX package takes a name)."""
    if not isinstance(arg, Axis):
        raise TypeError(f"{what} takes a parallel.axis.Axis (a rank's process "
                        f"group, from parallel.mesh), not {arg!r}")

"""A device mesh on ``torch.distributed``: events over ``data``, calorimeter
rows over ``block``.

Counterpart of npswf_tpu/parallel/mesh.py, which shards the event batch
over a ``jax.sharding.Mesh`` under ``shard_map``. Here a mesh is
``n_data x n_block`` ranks, one process each, numbered data-major (rank
``d * n_block + b`` holds event shard ``d`` and row shard ``b``, as
``np.asarray(devices).reshape(n_data, n_block)`` in the JAX package). Every
rank runs the same body and every collective is explicit:

- ``data``: events are independent, so nothing crosses this axis but the
  counters;
- ``block``: the matched filter, the peak search and the fits are
  block-local; the 3x3 cluster stencil exchanges one-row halos within the
  rank's block group (``ops.cluster_gate``), and ``enertot``/``integtot``
  are summed over it;
- the five fit/search counters (the reference's atomics, TEST_2.C:61-62)
  are summed over the world.

``launch`` starts the ranks with ``torch.multiprocessing`` (spawn), joins
them through a file rendezvous in a fresh directory (no port), and returns
what rank 0's body returns; ``gather_output`` assembles the global
``PipelineOutput`` on rank 0. Backends: NCCL with one card a rank, or gloo
(CPU ranks, or ranks that share a card; a gloo collective on CUDA tensors
is staged through the host, ``parallel.axis``). The backend is the caller's
choice: NCCL refuses a card named twice and nothing is substituted.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.engine.pipeline import (EventBatch, PipelineOutput,
                                             process_batch)
from npswf_tpu_torch.parallel.axis import Axis

# per-block calibration tensors, split along the block axis
_BLOCK_SHARDED = ("timeref", "preswf", "mfkern_rev", "mfint", "tdcoffset",
                  "cortime", "timemean2", "spline_coeffs", "spline_x0")
# PipelineOutput fields that are [E] (summed over the block group) and []
# (summed over the world); every other field is [E, B, ...]
_EVENT_FIELDS = ("enertot", "integtot")
_COUNTERS = ("n_fit_success", "n_fit_failure", "n_fit_dropped",
             "n_high_pulse", "n_search_dropped")
# how long a rank waits for the others at a collective before it fails
RANK_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """``n_data x n_block`` ranks on ``devices`` (one a rank, data-major),
    joined by ``backend``."""
    n_data: int
    n_block: int
    devices: Tuple[str, ...]
    backend: str

    @property
    def size(self) -> int:
        return self.n_data * self.n_block

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "block": self.n_block}


def make_mesh(cfg: NPSConfig, n_data: Optional[int] = None, n_block: int = 1,
              devices: Optional[Sequence[str]] = None,
              backend: Optional[str] = None) -> Mesh:
    """Mesh over (data, block). ``devices`` defaults to every CUDA card;
    ``n_block`` must divide nlin (row bands). ``backend`` defaults to NCCL
    on cards and gloo on the CPU; NCCL takes each card once."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [str(torch.device(d)) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_block
    need = n_data * n_block
    if need > len(devices) or need < 1:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    if cfg.nlin % n_block != 0:
        raise ValueError(f"n_block={n_block} must divide nlin={cfg.nlin}")
    devices = devices[:need]
    on_cards = all(d.startswith("cuda") for d in devices)
    if backend is None:
        backend = "nccl" if on_cards else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl":
        if not on_cards:
            raise ValueError(f"NCCL runs on CUDA devices, not {devices}")
        named = [torch.device(d).index or 0 for d in devices]
        if len(set(named)) < len(named):
            raise ValueError(f"NCCL takes one rank a card, and {devices} names "
                             f"one twice; ranks that share a card need "
                             f"backend='gloo'")
    return Mesh(n_data, n_block, tuple(devices), backend)


@dataclass
class RankMesh:
    """What a rank's body gets: the mesh, its rank and device, and its two
    axes (the block group of its data index, and the world)."""
    mesh: Mesh
    rank: int
    device: torch.device
    block: Axis
    world: Axis

    @property
    def data_index(self) -> int:
        return self.rank // self.mesh.n_block

    @property
    def block_index(self) -> int:
        return self.rank % self.mesh.n_block


def _join(mesh: Mesh, rank: int, rundir: str) -> RankMesh:
    """Join the mesh's process group as ``rank`` and make its block groups
    (every rank makes every group, in the same order)."""
    dev = torch.device(mesh.devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        mesh.backend, init_method="file://" + os.path.join(rundir, "rendezvous"),
        world_size=mesh.size, rank=rank, timeout=RANK_TIMEOUT)
    nb = mesh.n_block
    groups = [dist.new_group(list(range(d * nb, (d + 1) * nb)))
              for d in range(mesh.n_data)]
    return RankMesh(mesh, rank, dev,
                    block=Axis("block", groups[rank // nb], rank % nb, nb,
                               mesh.backend),
                    world=Axis("world", None, rank, mesh.size, mesh.backend))


def _rank_main(rank: int, mesh: Mesh, rundir: str, body, args) -> None:
    if not mesh.devices[rank].startswith("cuda"):
        torch.set_num_threads(1)
    rm = _join(mesh, rank, rundir)
    try:
        result = body(rm, *args)
        if rank == 0:
            tmp = os.path.join(rundir, "result.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(result, f)
            os.replace(tmp, os.path.join(rundir, "result.pkl"))
    finally:
        dist.destroy_process_group()


def launch(mesh: Mesh, body, *args, workdir: Optional[str] = None):
    """Run ``body(rank_mesh, *args)`` on every rank of ``mesh``, one spawned
    process a rank, and return rank 0's result. ``body`` must be importable
    by the children (a module-level function). A rank that fails fails the
    call; the others are stopped."""
    import torch.multiprocessing as mp
    rundir = tempfile.mkdtemp(prefix="npswf_mesh_", dir=workdir)
    try:
        mp.start_processes(_rank_main, args=(mesh, rundir, body, args),
                           nprocs=mesh.size, join=True, start_method="spawn")
        with open(os.path.join(rundir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


@contextlib.contextmanager
def world_of_one(device: str = "cuda:0",
                 workdir: Optional[str] = None) -> Iterator[RankMesh]:
    """A 1 x 1 mesh in this process (NCCL on a card, the first by default;
    gloo with ``device="cpu"``): the RankMesh a rank's body gets, to run
    the sharded code path without starting a process. The process group
    ends with the block."""
    mesh = Mesh(1, 1, (str(torch.device(device)),),
                "nccl" if device.startswith("cuda") else "gloo")
    rundir = tempfile.mkdtemp(prefix="npswf_mesh_", dir=workdir)
    try:
        rm = _join(mesh, 0, rundir)
        try:
            yield rm
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


# ----------------------------------------------------------------------
# Shards
# ----------------------------------------------------------------------
def _block_rows(cfg: NPSConfig, rm: RankMesh) -> slice:
    nb = cfg.nblocks // rm.mesh.n_block
    return slice(rm.block_index * nb, (rm.block_index + 1) * nb)


def _event_rows(E: int, rm: RankMesh) -> slice:
    if E % rm.mesh.n_data:
        raise ValueError(f"{E} events do not split over {rm.mesh.n_data} "
                         f"data shards")
    ne = E // rm.mesh.n_data
    return slice(rm.data_index * ne, (rm.data_index + 1) * ne)


def shard_calibration(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                      rm: RankMesh) -> Dict[str, torch.Tensor]:
    """This rank's calibration: the per-block tensors' rows of its block
    shard, the rest whole, on its device."""
    rows = _block_rows(cfg, rm)
    return {k: (v[rows] if k in _BLOCK_SHARDED else v).to(rm.device)
            for k, v in calib.items()}


def shard_event_batch(cfg: NPSConfig, batch: EventBatch,
                      rm: RankMesh) -> EventBatch:
    """This rank's events and blocks of a global batch, on its device (a
    dense batch gets its minsignal first: the minimum over all T)."""
    if batch.minsignal is None:
        batch = batch._replace(minsignal=batch.signal.amin(dim=-1))
    ev = _event_rows(batch.signal.shape[0], rm)
    rows = _block_rows(cfg, rm)
    return EventBatch(
        signal=batch.signal[ev, rows].to(rm.device),
        pres=batch.pres[ev, rows].to(rm.device),
        corr_time_HMS=batch.corr_time_HMS[ev].to(rm.device),
        evt=batch.evt[ev].to(rm.device), runnum=batch.runnum[ev].to(rm.device),
        minsignal=batch.minsignal[ev, rows].to(rm.device))


def make_sharded_pipeline(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                          rm: RankMesh):
    """``fn(local batch) -> local PipelineOutput`` for this rank:
    ``process_batch`` with its block group and the world as axes. ``calib``
    is this rank's (``shard_calibration``)."""
    def fn(batch: EventBatch) -> PipelineOutput:
        return process_batch(cfg, calib, batch, block_axis=rm.block,
                             block_shards=rm.mesh.n_block,
                             reduce_axes=(rm.world,))
    return fn


def gather_output(out: PipelineOutput,
                  rm: RankMesh) -> Optional[PipelineOutput]:
    """The global PipelineOutput (host numpy arrays) on rank 0, None on
    the others: the [E, B, ...] fields reassembled from every shard, the
    [E] totals from each data index's first block shard, the counters (the
    same on every rank) from rank 0."""
    local = PipelineOutput(*(t.cpu().numpy() for t in out))
    parts = [None] * rm.mesh.size if rm.rank == 0 else None
    dist.gather_object(local, parts, dst=0)
    if rm.rank != 0:
        return None
    nd, nb = rm.mesh.n_data, rm.mesh.n_block
    fields = {}
    for name in PipelineOutput._fields:
        if name in _COUNTERS:
            fields[name] = getattr(parts[0], name)
        elif name in _EVENT_FIELDS:
            fields[name] = np.concatenate(
                [getattr(parts[d * nb], name) for d in range(nd)], axis=0)
        else:
            fields[name] = np.concatenate(
                [np.concatenate([getattr(parts[d * nb + b], name)
                                 for b in range(nb)], axis=1)
                 for d in range(nd)], axis=0)
    return PipelineOutput(**fields)


# ----------------------------------------------------------------------
# One batch over a mesh, from the parent process
# ----------------------------------------------------------------------
def _process_body(rm: RankMesh, cfg: NPSConfig, calib_arrays, batch_np,
                  dtype: torch.dtype):
    from npswf_tpu_torch import kernels
    from npswf_tpu_torch.core.params import calib_to_torch
    calib = shard_calibration(cfg, calib_to_torch(calib_arrays, "cpu", dtype),
                              rm)
    batch = EventBatch(*(None if a is None else torch.as_tensor(a)
                         for a in batch_np))
    batch = batch._replace(signal=batch.signal.to(dtype),
                           corr_time_HMS=batch.corr_time_HMS.to(dtype),
                           minsignal=None if batch.minsignal is None
                           else batch.minsignal.to(dtype))
    local = shard_event_batch(cfg, batch, rm)
    kernels.reset_counts()
    out = make_sharded_pipeline(cfg, calib, rm)(local)
    if rm.device.type == "cuda":
        torch.cuda.synchronize(rm.device)
    counts = {"launches": dict(kernels.launches),
              "plain_calls": dict(kernels.plain_calls)}
    every = [None] * rm.mesh.size if rm.rank == 0 else None
    dist.gather_object(counts, every, dst=0)
    return gather_output(out, rm), every


def sharded_process_batch(mesh: Mesh, cfg: NPSConfig, calib_arrays,
                          batch: EventBatch, workdir: Optional[str] = None):
    """``process_batch`` of one global batch over ``mesh`` (the ranks
    started for this call): returns (the global PipelineOutput as host
    numpy arrays, each rank's kernel counts). ``calib_arrays`` is
    ``CalibrationBundle.device_arrays(cfg)``; ``batch`` holds host
    tensors or arrays, its floats in the compute dtype."""
    from npswf_tpu_torch.runtime.executor import torch_dtype
    batch_np = EventBatch(*(None if a is None else np.asarray(
        a.cpu() if isinstance(a, torch.Tensor) else a) for a in batch))
    return launch(mesh, _process_body, cfg, calib_arrays, batch_np,
                  torch_dtype(cfg), workdir=workdir)


def _cluster_body(rm: RankMesh, cfg: NPSConfig, signal: np.ndarray):
    from npswf_tpu_torch.ops.cluster_gate import cluster_sums
    sig = torch.as_tensor(signal)
    ev = _event_rows(sig.shape[0], rm)
    local = sig[ev, _block_rows(cfg, rm)].to(rm.device)
    out = cluster_sums(cfg, local, rm.block, rm.mesh.n_block).cpu().numpy()
    parts = [None] * rm.mesh.size if rm.rank == 0 else None
    dist.gather_object(out, parts, dst=0)
    if rm.rank != 0:
        return None
    nb = rm.mesh.n_block
    return np.concatenate(
        [np.concatenate(parts[d * nb:(d + 1) * nb], axis=1)
         for d in range(rm.mesh.n_data)], axis=0)


def sharded_cluster_sums(mesh: Mesh, cfg: NPSConfig, signal: np.ndarray,
                         workdir: Optional[str] = None) -> np.ndarray:
    """``ops.cluster_sums`` of a global [E, B, T] signal over ``mesh``'s
    shards, halos exchanged, reassembled: the stencil alone, as the JAX
    package's halo test runs it."""
    return launch(mesh, _cluster_body, cfg, np.asarray(signal),
                  workdir=workdir)

"""Streaming segment executor: a raw segment in, a WF file out.

Ported from npswf_tpu/runtime/executor.py (the reference's job control,
TEST_2.C:281-534, 1302-1439):

- events stream through fixed-size batches; the last batch is zero-padded
  and trimmed on output,
- two stage workers decode, upload and run batches ahead of the main
  thread, which fetches each batch's packet in order; a writer thread
  persists each batch as a part file and records it in a progress sidecar
  (batch-granular resume: a rerun skips completed ranges),
- the parts are merged in event order into the final WF file with the
  (runnum, evt) index (ref TEST_2.C:1383-1432), each part read once and
  the file's members DEFLATEd on a thread pool (``io.merge``),
- per-stage wall timers and fit-health counters are reported at exit,
  beside the program's counters (``kernels.counts_report``).

Each stage is a span (``utils.timers.span``): ``runtime.decode``,
``runtime.upload`` and ``runtime.pipeline`` on the stage workers,
``runtime.write`` on the writer, and on the main thread, inside
``runtime.run_segment``, ``runtime.produce_wait`` (waiting for the next
produced group), ``runtime.fetch``, ``runtime.unpack``,
``runtime.write_wait`` (waiting for the writer's backlog) and
``runtime.merge``. The ``StageTimer`` records each under its stage's name
(``decode``, ...). ``upload``, ``pipeline`` and ``fetch`` are host time:
what the thread spent enqueueing and waiting, not the device's work.

On a CUDA device each stage worker issues its work on a stream of its
own: the upload from pinned host memory, ``process_batch`` (whose kernels
launch on the current stream) and the packet's copy back into pinned
memory, after which it records an event; the main thread's in-order fetch
waits on that event. ``process_batch`` itself waits for the device twice
a batch (the bucket sizes, the fit's rung tallies), so each worker runs
its batch to the end; the two workers overlap one batch's host work with
the other's device work. On the card each worker's calls replay CUDA
graphs of an instance it checks out for the call (``engine/graphs.py``),
so two instances serve a pass and the next pass's workers reuse them.

The device is the card unless the caller asks for the CPU
(``device="cpu"``); without a card that is an error, never a fallback.

With a ``mesh`` (``parallel.mesh``) the batches run over the mesh's ranks,
one at a time, and rank 0 writes the file (``_run_segment_mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.calibration import CalibrationBundle
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import calib_to_torch
from npswf_tpu_torch.engine.pipeline import (EventBatch, PipelineOutput,
                                             make_pipeline_packed_chain,
                                             process_batch, unflatten_packet)
from npswf_tpu_torch.io.decode import DecodedBatch, decode_segment
from npswf_tpu_torch.io.merge import merge_parts
from npswf_tpu_torch.io.rawstream import RawSegment
from npswf_tpu_torch.io.writer import WFWriter
from npswf_tpu_torch.parallel.mesh import (gather_output, launch,
                                           make_sharded_pipeline,
                                           shard_calibration, shard_event_batch)
from npswf_tpu_torch.utils.timers import StageTimer, device_trace, span

log = logging.getLogger("npswf")


@dataclass
class RunResult:
    n_events: int
    n_fit_success: int
    n_fit_failure: int
    n_fit_dropped: int
    wall_time: float
    events_per_sec: float
    blocks_per_sec: float
    out_path: str
    # runtime-guard tallies (the reference's inline warnings as counters)
    n_bad_slot: int = 0      # events aborted on an out-of-range slot (ref :867-872)
    n_oversize: int = 0      # events skipped by the Ndata guard (ref :830-836)
    n_truncated: int = 0     # events whose stream ended mid-block
    n_high_pulse: int = 0    # lanes with npulse > maxwfpulses-2 (ref :209-213)
    n_search_dropped: int = 0  # present lanes beyond cfg.search_capacity


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the CPU is "
            "asked for (device='cpu', or --cpu on the command line)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(cfg: NPSConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "float64": torch.float64}[np.dtype(cfg.compute_dtype).name]


def _warn_bad_events(d: DecodedBatch, n_valid: int) -> None:
    """The reference's per-event warnings (slot problem ref :867-872, Ndata
    guard ref :830-836), for a decoded batch."""
    bad = d.bad_slot[:n_valid]
    for e in np.nonzero(bad != -1)[0]:
        kind = {-2: "truncated stream", -3: "oversize (Ndata guard)"}.get(
            int(bad[e]), f"slot number problem (slot {bad[e]})")
        log.warning("event %s: %s", d.evt[e], kind)


def _pad_decoded(cfg: NPSConfig, d: DecodedBatch, target: int) -> DecodedBatch:
    n = d.signal.shape[0]
    if n == target:
        return d
    pad = target - n

    def z(a, fill=0):
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=0)

    return DecodedBatch(
        signal=z(d.signal), pres=z(d.pres), minsignal=z(d.minsignal, 1e6),
        bad_slot=z(d.bad_slot, -1), corr_time_HMS=z(d.corr_time_HMS),
        sampampl=z(d.sampampl, -100.0), samptime=z(d.samptime, -100.0),
        sampener=z(d.sampener, -100.0), sampped=z(d.sampped, -100.0),
        hcana_npulse=z(d.hcana_npulse), evt=z(d.evt, -1), runnum=z(d.runnum, -1))


def _to_event_batch(cfg: NPSConfig, d: DecodedBatch, dtype: torch.dtype,
                    device) -> EventBatch:
    """Decoded batch -> EventBatch on ``device``, plainly (one copy a
    field); ``_upload_batch`` is the executor's route."""
    B = cfg.nblocks

    def t(a, dt=None):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return EventBatch(
        signal=t(d.signal, dtype), pres=t(d.pres[:, :B].astype(bool)),
        corr_time_HMS=t(d.corr_time_HMS, dtype), evt=t(d.evt),
        runnum=t(d.runnum), minsignal=t(d.minsignal, dtype))


# ---------------------------------------------------------------------
# Upload: few host-to-device transfers a batch
# ---------------------------------------------------------------------
# The [E, B, T] signal dominates the upload; two lossless reducers:
#  - int16 when every sample is integral (real FADC streams carry raw ADC
#    counts stored as doubles, ref TEST_2.C:854-889), cast back on device;
#  - present-lane compaction when the batch is sparse: only the present
#    rows and their indices go up, into zeros on the device — exact,
#    because the decoder zero-fills absent lanes. Only the real rows are
#    sent (no padding rows that point past the end).

def _maybe_int16(sig: np.ndarray) -> np.ndarray:
    """Lossless int16 view of an integral float array, else the original."""
    if sig.size == 0:
        return sig
    lo, hi = sig.min(), sig.max()
    if lo < -32768.0 or hi > 32767.0:
        return sig
    if not np.array_equal(sig, np.rint(sig)):
        return sig
    return sig.astype(np.int16)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and an
    asynchronous copy on the current stream for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _upload_signal(cfg: NPSConfig, d: DecodedBatch, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """[E, B, T] signal on the device by the cheapest lossless route."""
    B, T = cfg.nblocks, cfg.ntime
    E = d.signal.shape[0]
    pres = d.pres[:, :B].astype(bool)
    rows = np.flatnonzero(pres.reshape(-1))
    if rows.size <= (E * B) // 2:
        dense = torch.zeros((E * B, T), dtype=dtype, device=device)
        if rows.size:
            sig_c = _maybe_int16(d.signal.reshape(E * B, T)[rows])
            dense[_to_device(rows, device)] = _to_device(sig_c, device).to(dtype)
        return dense.reshape(E, B, T)
    return _to_device(_maybe_int16(d.signal), device).to(dtype)


def _upload_batch(cfg: NPSConfig, d: DecodedBatch, dtype: torch.dtype,
                  device: torch.device) -> EventBatch:
    """Decoded batch -> EventBatch: one fp64 array of every small field
    and the (int16 where lossless) signal, dense or as its present rows
    and their indices."""
    B = cfg.nblocks
    E = d.signal.shape[0]
    combo = np.empty((E, 2 * B + 3), np.float64)
    combo[:, :B] = d.minsignal
    combo[:, B:2 * B] = d.pres[:, :B]
    combo[:, 2 * B] = d.corr_time_HMS
    combo[:, 2 * B + 1] = d.evt
    combo[:, 2 * B + 2] = d.runnum
    c = _to_device(combo, device)
    return EventBatch(
        signal=_upload_signal(cfg, d, dtype, device),
        pres=c[:, B:2 * B] != 0.0,
        corr_time_HMS=c[:, 2 * B].to(dtype),
        evt=c[:, 2 * B + 1].to(torch.int32),
        runnum=c[:, 2 * B + 2].to(torch.int32),
        minsignal=c[:, :B].to(dtype))


def _pow2(n: int) -> int:
    """Next power of two."""
    return 1 << max(int(n) - 1, 1).bit_length()


def packet_caps(E: int, B: int, n_pres0: int):
    """(pack_cap, lane_cap) sized from the first batch's present lanes:
    a sparse readout (at most a quarter of the lanes) takes the slab
    packet (lane_cap > 0) with a smaller pulse buffer; later batches that
    overflow fall back to the dense fetch."""
    if n_pres0 <= (E * B) // 4:
        return (min(_pow2(max(4096, 8 * n_pres0)), 2 * E * B),
                min(_pow2(max(1024, 2 * n_pres0)), E * B))
    return 2 * E * B, 0


def output_to_host(out: PipelineOutput) -> PipelineOutput:
    """PipelineOutput as host numpy arrays (what ``WFWriter.add_batch``
    reads)."""
    return PipelineOutput(*(t.cpu().numpy() for t in out))


class _Progress:
    """Sidecar recording completed batch ranges for resume."""

    def __init__(self, path: str):
        self.path = path
        self.completed = set()
        if os.path.exists(path):
            with open(path) as f:
                self.completed = {tuple(r) for r in json.load(f)["completed"]}

    def done(self, lo: int, hi: int) -> bool:
        return (lo, hi) in self.completed

    def mark(self, lo: int, hi: int) -> None:
        self.completed.add((lo, hi))
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"completed": sorted(self.completed)}, f)
        os.replace(tmp, self.path)


class _Streams:
    """One CUDA stream per worker thread (none on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._local = threading.local()

    def get(self) -> Optional[torch.cuda.Stream]:
        if self.device.type != "cuda":
            return None
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return s


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class _SegmentJob:
    """What both segment paths do alike: the plan, the decode, the part
    writes and the ending.

    The plan: the batch ranges a resume has not completed (``pending``),
    the parts directory, which only the ``lead`` (the writer) creates, and
    the progress sidecar, read here. ``decode`` gives a batch padded to the
    batch size, ``write`` persists one batch as a part file and marks it,
    ``finish`` merges the parts into the WF file. The run's wall time
    starts here."""

    def __init__(self, cfg: NPSConfig, cal: CalibrationBundle,
                 seg: RawSegment, out_path: str, batch_size: int,
                 resume: bool, use_native_decode: bool, timers: StageTimer,
                 progress_every: int, lead: bool = True):
        self.t_start = time.perf_counter()
        self.cfg, self.cal, self.seg, self.out_path = cfg, cal, seg, out_path
        self.batch_size, self.use_native = batch_size, use_native_decode
        self.timers, self.progress_every = timers, progress_every
        self.parts_dir = out_path + ".parts"
        if lead:
            os.makedirs(self.parts_dir, exist_ok=True)
        self.progress = _Progress(out_path + ".progress.json")
        ranges = [(lo, min(lo + batch_size, seg.n_events))
                  for lo in range(0, seg.n_events, batch_size)]
        self.pending = [r for r in ranges
                        if not (resume and self.progress.done(*r))]
        if lead and len(self.pending) < len(ranges):
            log.info("resume: skipping %d completed batches",
                     len(ranges) - len(self.pending))
        self.done_events = 0
        self.last_done = None

    def decode(self, lo: int, hi: int) -> DecodedBatch:
        with span("runtime.decode", self.timers):
            return _pad_decoded(self.cfg, decode_segment(
                self.cfg, self.cal, self.seg, lo, hi,
                use_native=self.use_native), self.batch_size)

    def write(self, lo: int, hi: int, d_pad: DecodedBatch, out) -> None:
        """Batch [lo, hi) as a part file, marked in the sidecar; ``out`` is
        a host WriterPacket or a PipelineOutput of host arrays."""
        n_valid = hi - lo
        _warn_bad_events(d_pad, n_valid)
        # inter-batch completion gap: its median is the steady-state
        # batch period
        t_now = time.perf_counter()
        if self.last_done is not None:
            self.timers.record("interbatch", t_now - self.last_done)
        self.last_done = t_now
        with span("runtime.write", self.timers):
            w = WFWriter(self.cfg)
            if isinstance(out, PipelineOutput):
                # in the packet's type (fp32), so that a part's values do
                # not depend on the route that brought it
                w.add_batch(PipelineOutput(*(
                    np.asarray(a, np.float32) if a.dtype.kind == "f" else a
                    for a in out)), d_pad, n_valid=n_valid)
            else:
                w.add_packet(out, d_pad, n_valid=n_valid)
            w.finalize(os.path.join(self.parts_dir,
                                    f"part_{lo:09d}_{hi:09d}.npz"),
                       compress=False)
        self.progress.mark(lo, hi)
        self.done_events += n_valid
        if self.done_events % self.progress_every < self.batch_size:
            dt_el = time.perf_counter() - self.t_start
            log.info(" Entry = %d  elapsed=%.2fs (%.0f ev/s)", hi, dt_el,
                     self.done_events / max(dt_el, 1e-9))

    def finish(self, compress_output: bool) -> RunResult:
        """The ordered merge of the parts (the temp->final clone, ref
        :1396-1432), the parts and the sidecar removed, the totals logged."""
        with span("runtime.merge", self.timers):
            part_paths = [os.path.join(self.parts_dir, f)
                          for f in sorted(os.listdir(self.parts_dir))]
            merged = merge_parts(part_paths, self.out_path,
                                 payload=dict(self.seg.payload),
                                 compress=compress_output)
        shutil.rmtree(self.parts_dir, ignore_errors=True)
        if os.path.exists(self.progress.path):
            os.remove(self.progress.path)
        n = self.seg.n_events
        wall = time.perf_counter() - self.t_start
        res = RunResult(**dict(dataclasses.asdict(merged), n_events=n),
                        wall_time=wall, events_per_sec=n / max(wall, 1e-9),
                        blocks_per_sec=n * self.cfg.nblocks / max(wall, 1e-9),
                        out_path=self.out_path)
        log.info("Total failed fits: %d total fits succeed: %d (dropped %d)",
                 res.n_fit_failure, res.n_fit_success, res.n_fit_dropped)
        guards = (res.n_bad_slot, res.n_oversize, res.n_truncated,
                  res.n_high_pulse, res.n_search_dropped)
        if any(guards):
            log.warning(
                "decode/search guards: %d bad-slot, %d oversize-skipped, "
                "%d truncated events; %d high-pulse-count blocks; "
                "%d search-capacity-dropped lanes", *guards)
        log.info(self.timers.report())
        log.info(kernels.counts_report())
        return res


def run_segment(cfg: NPSConfig, cal: CalibrationBundle, seg: RawSegment,
                out_path: str, batch_size: int = 64,
                mesh=None, resume: bool = True,
                use_native_decode: bool = True,
                timers: Optional[StageTimer] = None,
                progress_every: int = 1000,
                profile_dir: Optional[str] = None,
                compress_output: bool = True,
                chain_batches: int = 1,
                device="cuda") -> RunResult:
    """Process a full raw segment into a WF output file.

    ``device`` is where the batches run: the card by default, ``"cpu"``
    only when asked for (without a card a CUDA device raises).
    ``profile_dir`` wraps the event loop in a ``torch.profiler`` trace
    (``utils.timers.device_trace``). ``compress_output`` controls DEFLATE
    of the final merged file only; part files are written uncompressed.
    ``chain_batches`` > 1 runs k batches a call and fetches one [k, total]
    packet stack; results are bit-identical to k single calls and resume
    stays per batch. ``mesh`` (a ``parallel.mesh.Mesh``) runs the batches
    over its ranks instead of on ``device``: see ``_run_segment_mesh``.
    """
    timers = timers or StageTimer()
    if mesh is not None:
        return _run_segment_mesh(cfg, cal, seg, out_path, batch_size, mesh,
                                 resume, use_native_decode, timers,
                                 progress_every, profile_dir, compress_output)
    with span("runtime.run_segment"):
        dev = resolve_device(device)
        job = _SegmentJob(cfg, cal, seg, out_path, batch_size, resume,
                          use_native_decode, timers, progress_every)
        dtype = torch_dtype(cfg)
        calib = calib_to_torch(cal.device_arrays(cfg), dev, dtype)
        if dev.type == "cuda":
            # the workers' streams read the calibration
            torch.cuda.current_stream(dev).synchronize()

        # ---- packet sizing from the first batch's occupancy ----------------
        E, B = batch_size, cfg.nblocks
        first = {}      # the first batch, decoded here, for its stage worker
        pack_cap, lane_cap = 2 * E * B, 0
        if job.pending:
            first[job.pending[0]] = d0 = job.decode(*job.pending[0])
            pack_cap, lane_cap = packet_caps(
                E, B, int(d0.pres[:, :B].astype(bool).sum()))
        k_chain = max(int(chain_batches), 1)
        packed_chain = make_pipeline_packed_chain(cfg, calib, pack_cap, lane_cap)
        streams = _Streams(dev)

        trace_ctx = device_trace(profile_dir)
        trace_ctx.__enter__()

        def produce(group):
            """Decode -> upload -> run -> start the packet's copy back, for a
            chain of batch ranges (on a stage worker thread, on its stream)."""
            stream = streams.get()
            items = []
            with _on(stream):
                for lo, hi in group:
                    d_pad = first.pop((lo, hi), None) or job.decode(lo, hi)
                    with span("runtime.upload", timers):
                        dev_batch = _upload_batch(cfg, d_pad, dtype, dev)
                    items.append((lo, hi, d_pad, dev_batch))
                with span("runtime.pipeline", timers):
                    flat = packed_chain([it[3] for it in items])
                    if stream is None:
                        return items, flat, None, None
                    # one copy back into pinned memory, in stream order
                    host = torch.empty(flat.shape, dtype=flat.dtype,
                                       pin_memory=True)
                    host.copy_(flat, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
            return items, host, done, stream

        # three-deep pipeline: 2 stage workers (decode, upload, run), the main
        # thread fetches results in order, 1 writer thread persists parts.
        groups = iter([job.pending[i:i + k_chain]
                       for i in range(0, len(job.pending), k_chain)])
        stage_pool = ThreadPoolExecutor(max_workers=2)
        write_pool = ThreadPoolExecutor(max_workers=1)
        max_inflight = 3
        futs = deque()
        wfuts = deque()

        def submit_next():
            group = next(groups, None)
            if group is not None:
                futs.append(stage_pool.submit(produce, group))

        try:
            for _ in range(max_inflight):
                submit_next()
            while futs:
                with span("runtime.produce_wait", timers):
                    items, flat, done, stream = futs.popleft().result()
                submit_next()
                with span("runtime.fetch", timers):
                    if done is not None:
                        done.synchronize()
                    rows = list(flat.numpy())                   # [k, total]
                for (lo, hi, d_pad, dev_batch), buf in zip(items, rows):
                    with span("runtime.unpack"):
                        pkt, lane_ovf = unflatten_packet(
                            buf, batch_size, cfg.nblocks, pack_cap,
                            pres=d_pad.pres[:, :B], lane_cap=lane_cap,
                            P=cfg.maxwfpulses)
                        # slab packets (lane_cap > 0) have no element
                        # capacity — only lane overflow forces the dense
                        # fallback
                        if lane_ovf or (lane_cap == 0
                                        and (int(pkt.n_wf) > pack_cap
                                             or int(pkt.n_h) > pack_cap)):
                            # occupancy burst beyond the batch-0 sizing: run
                            # this batch again through the dense pipeline, on
                            # the stream that holds its tensors, and hand the
                            # writer host arrays
                            log.warning(
                                "batch %d-%d: writer-packet overflow (%d/%d "
                                "wf, %d/%d h, lane_ovf=%s); re-running batch "
                                "dense", lo, hi, int(pkt.n_wf), pack_cap,
                                int(pkt.n_h), pack_cap, lane_ovf)
                            with _on(stream):
                                pkt = output_to_host(
                                    process_batch(cfg, calib, dev_batch))
                    wfuts.append(write_pool.submit(job.write, lo, hi,
                                                   d_pad, pkt))
                with span("runtime.write_wait", timers):
                    while len(wfuts) > 2:
                        wfuts.popleft().result()
            with span("runtime.write_wait", timers):
                for wf_ in wfuts:
                    wf_.result()
        finally:
            # on error: let queued part writes finish (progress sidecar stays
            # resumable), then surface the original exception
            trace_ctx.__exit__(None, None, None)
            stage_pool.shutdown(wait=True)
            write_pool.shutdown(wait=True)

        return job.finish(compress_output)


# ---------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------
def _run_segment_mesh(cfg, cal, seg, out_path, batch_size, mesh, resume,
                      use_native_decode, timers, progress_every, profile_dir,
                      compress_output) -> RunResult:
    """``run_segment`` over the ranks of ``mesh``, as the JAX package's mesh
    path: one batch at a time (chaining does not apply). Every rank decodes
    the batch and takes its shard; the global output is gathered on rank 0,
    which writes its host arrays as the part, records it for resume and
    merges the parts at the end. The caller's ``timers`` get rank 0's
    stage samples."""
    # the raw stream (about 1 MB a dense event) reaches the ranks as one
    # file that each maps, not as a pickled copy a rank
    stream_path = out_path + ".stream.npy"
    np.save(stream_path, seg.stream)
    try:
        res, samples = launch(mesh, _mesh_rank, cfg, cal,
                              dataclasses.replace(seg, stream=np.empty(0)),
                              stream_path, out_path, batch_size, resume,
                              use_native_decode, progress_every, profile_dir,
                              compress_output)
    finally:
        os.remove(stream_path)
    for name, values in samples.items():
        for dt in values:
            timers.record(name, dt)
    return res


def _mesh_rank(rm, cfg, cal, seg, stream_path, out_path, batch_size, resume,
               use_native_decode, progress_every, profile_dir,
               compress_output):
    """One rank's part of ``_run_segment_mesh`` (``seg`` without its
    stream, which is mapped from ``stream_path``); rank 0 returns
    (RunResult, its stage samples), the others None."""
    timers = StageTimer()
    lead = rm.rank == 0
    seg = dataclasses.replace(seg, stream=np.load(stream_path, mmap_mode="r"))
    # every rank reads the sidecar before the first batch's collectives,
    # so before rank 0 can mark anything
    job = _SegmentJob(cfg, cal, seg, out_path, batch_size, resume,
                      use_native_decode, timers, progress_every, lead)
    dtype = torch_dtype(cfg)
    calib = shard_calibration(
        cfg, calib_to_torch(cal.device_arrays(cfg), "cpu", dtype), rm)
    pipeline = make_sharded_pipeline(cfg, calib, rm)
    with device_trace(profile_dir if lead else None):
        for lo, hi in job.pending:
            d_pad = job.decode(lo, hi)
            with span("runtime.upload", timers):
                local = shard_event_batch(
                    cfg, _to_event_batch(cfg, d_pad, dtype, "cpu"), rm)
            with span("runtime.pipeline", timers):
                out = pipeline(local)
            with span("runtime.fetch", timers):
                glob = gather_output(out, rm)
            if lead:
                job.write(lo, hi, d_pad, glob)
    if not lead:
        return None
    return job.finish(compress_output), dict(timers.samples)

"""process_batch's device work as two CUDA graph replays around one read of
the bucket sizes.

A call that ``pipeline.graph_route`` admits (on the card, not ``plain``,
no mesh axes, every bucket fitted by K3's one-launch ladder) is served by
an instance, which holds:

- static copies of the batch's inputs (``signal``, ``pres``,
  ``minsignal``, ``corr_time_HMS``) and of the calibration the call reads;
- graph A: the search, its lane compaction included, the gate and the
  bucket sizes (``pipeline._search_and_gate``);
- one graph B for each pattern of buckets with lanes it has met, captured
  on first use: their fits, the resolution and the diagnostics
  (``pipeline._fit_and_resolve``).

All of an instance's graphs share one memory pool. A call copies the batch
in (the calibration only when it is not the one last copied), replays A,
reads the bucket sizes (the call's first sync), replays the B of that
pattern, clones the outputs (an answer never aliases graph memory: callers
keep answers and pack them on other threads) and reads the rung tallies
(the second sync). The kernels, their order and their inputs are those of
the eager body; only the host's way of issuing them differs.

An instance's first call runs the eager body (``pipeline._eager``), which
primes what runs once a process (the search's taps, the kernels' modules)
and the allocator; A and that call's B are captured after it. A capture
holds a lock, so one thread captures at a time, and uses
``capture_error_mode="thread_local"``, so another thread's calls run on
meanwhile.

Instances are keyed by the configuration and the shapes, types and device
of the inputs. A call checks one out for itself and returns it after, so
concurrent callers (the segment executor's two stage workers) hold one
each and the next pass's threads reuse them; at most ``MAX_IDLE`` idle
instances are kept, the least recently used dropped first.

Bookkeeping equals the eager body's: what the captured work counts that
the data does not decide (``kernels.launches``, ``engine.search_lanes``,
``fit.launched_lanes``, ``fit.ladder_fused``) is recorded at capture
(``kernels.recording``) and added at each replay; what the data decides
(``fit.stage1_lanes``, ``fit.rungs``, ``fit.retry_lanes``) comes from the
two reads. Counters ``engine.graph_replays`` (calls served by replay) and
``engine.graph_captures``; spans ``engine.graph.replay`` and
``engine.graph.capture``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.engine import pipeline
from npswf_tpu_torch.engine.pipeline import EventBatch, PipelineOutput
from npswf_tpu_torch.fit.lm_kernel import ladder_pullbacks
from npswf_tpu_torch.utils.timers import span

MAX_IDLE = 4
_idle: List[Tuple[tuple, "_Instance"]] = []   # least recently used first
_idle_lock = threading.Lock()
_capture_lock = threading.Lock()


class CudaGraph:
    """One CUDA graph: ``capture(fn, pool)`` records ``fn``'s device work
    in ``pool`` (None: a new pool) and returns what ``fn`` returned;
    ``replay()`` runs it on the current stream."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn, pool):
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            return fn()

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()


new_graph = CudaGraph    # what an instance captures with


class _Captured(NamedTuple):
    graph: CudaGraph
    out: object          # what the captured function returned
    counted: tuple       # kernels.recording()'s counters of the capture


def _key(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
         batch: EventBatch) -> tuple:
    def form(t):
        return None if t is None else (tuple(t.shape), t.dtype)
    return (cfg, batch.signal.device,
            tuple(form(t) for t in (batch.signal, batch.pres,
                                    batch.corr_time_HMS, batch.minsignal)),
            tuple(form(calib[k]) if isinstance(calib[k], torch.Tensor)
                  else None for k in pipeline.CALIB_KEYS))


def run(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
        batch: EventBatch) -> PipelineOutput:
    """One process_batch call on the graph route."""
    key = _key(cfg, calib, batch)
    inst = _checkout(key) or _Instance(cfg, calib, batch)
    out = inst.call(cfg, calib, batch)
    _checkin(key, inst)       # an instance whose call raised is dropped
    return out


def _checkout(key: tuple) -> Optional["_Instance"]:
    with _idle_lock:
        for i in range(len(_idle) - 1, -1, -1):
            if _idle[i][0] == key:
                return _idle.pop(i)[1]
    return None


def _checkin(key: tuple, inst: "_Instance") -> None:
    with _idle_lock:
        _idle.append((key, inst))
        dropped = _idle.pop(0)[1] if len(_idle) > MAX_IDLE else None
    if dropped is not None:
        dropped.retire()


def clear() -> None:
    """Drop every idle instance (and its graphs' memory)."""
    with _idle_lock:
        dropped = [inst for _, inst in _idle]
        _idle.clear()
    for inst in dropped:
        inst.retire()


class _Instance:
    """The static inputs, graph A and the Bs of one key."""

    def __init__(self, cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                 batch: EventBatch):
        sig = batch.signal
        self.device = sig.device
        self.N = sig.shape[0] * sig.shape[1]

        def like(t):
            return None if t is None else torch.empty_like(
                t, memory_format=torch.contiguous_format)
        self.batch = EventBatch(
            signal=like(sig), pres=like(batch.pres),
            corr_time_HMS=like(batch.corr_time_HMS), evt=None, runnum=None,
            minsignal=like(batch.minsignal))
        self.cal = {k: torch.empty_like(v) for k, v in pipeline._calib_tensors(
            calib, sig.dtype, self.device).items()}
        # the calibration's arrays last copied in, kept so that no other
        # array can take their identities
        self.calib_src: Optional[tuple] = None
        self.pool = None
        self.a: Optional[_Captured] = None
        self.b: Dict[Tuple[bool, ...], _Captured] = {}
        self.done = None          # an event after the last call's work

    def call(self, cfg: NPSConfig, calib: Dict[str, torch.Tensor],
             batch: EventBatch) -> PipelineOutput:
        if self.device.type != "cuda":       # a stand-in's instance
            return self._call(cfg, calib, batch)
        # a graph replays on the current device's stream
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            if self.done is not None:
                # the last call may have run on another thread's stream
                stream.wait_event(self.done)
            out = self._call(cfg, calib, batch)
            self.done = self.done or torch.cuda.Event()
            self.done.record(stream)
        return out

    def _call(self, cfg: NPSConfig, calib: Dict[str, torch.Tensor],
              batch: EventBatch) -> PipelineOutput:
        if self.a is None:
            out, filled = pipeline._eager(cfg, calib, batch, None, 1, (),
                                          False)
            ladder_pullbacks(cfg, self.device)
            self._capture(cfg, filled)
            return out
        with span("engine.graph.replay"):
            return self._replay(cfg, calib, batch)

    def _capture(self, cfg: NPSConfig, filled: Tuple[bool, ...]) -> None:
        with _capture_lock, span("engine.graph.capture"):
            if self.a is None:
                self.a = self._graph(lambda: pipeline._search_and_gate(
                    cfg, self.cal, self.batch, None, 1, False))
            front = self.a.out
            self.b[filled] = self._graph(lambda: pipeline._fit_and_resolve(
                cfg, self.cal, self.batch, front, filled, None, False))

    def _graph(self, fn) -> _Captured:
        g = new_graph()
        with kernels.recording() as counted:
            out = g.capture(fn, self.pool)
        if self.pool is None:
            self.pool = g.pool()
        kernels.count("engine.graph_captures")
        return _Captured(g, out, counted)

    def _load(self, calib: Dict[str, torch.Tensor], batch: EventBatch) -> None:
        src = tuple(calib[k] for k in pipeline.CALIB_KEYS)
        if self.calib_src is None or any(
                a is not b for a, b in zip(src, self.calib_src)):
            for k, v in pipeline._calib_tensors(
                    calib, self.batch.signal.dtype, self.device).items():
                self.cal[k].copy_(v)
            self.calib_src = src
        mine = self.batch
        mine.signal.copy_(batch.signal)
        mine.pres.copy_(batch.pres)
        mine.corr_time_HMS.copy_(batch.corr_time_HMS)
        if mine.minsignal is not None:
            mine.minsignal.copy_(batch.minsignal)

    def _replay(self, cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                batch: EventBatch) -> PipelineOutput:
        self._load(calib, batch)
        self.a.graph.replay()
        filled = pipeline._bucket_sizes(cfg, self.a.out.sizes, self.N)
        if filled not in self.b:
            self._capture(cfg, filled)
        b = self.b[filled]
        b.graph.replay()
        out, tallies = b.out
        out = PipelineOutput(*(t.clone() for t in out))
        pipeline._fold_tallies(tallies)
        kernels.add(self.a.counted)
        kernels.add(b.counted)
        kernels.count("engine.graph_replays")
        return out

    def retire(self) -> None:
        """Wait for the last call's work, so the graphs' memory may go."""
        if self.done is not None:
            kernels.count("sync.engine.graph_retire")
            self.done.synchronize()

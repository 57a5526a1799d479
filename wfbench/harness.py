"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, the result line.

The two entries the cells drive:

- ``run_segment`` (``SegmentEntry``): passes over the cell's raw segment
  back to back, each into a fresh WF file under ``TMPDIR`` with the users'
  defaults (the traffic file's ``batch_size``, ``chain_batches``,
  ``compress_output``); the window runs from the first pass's start to the
  last pass's end, passes starting until ``--seconds`` have gone by.
- ``process_batch`` (``BatchEntry``): calls back to back on a pool of
  device-resident batches, cycled, each ending in a synchronize; the
  window runs from the first call's start to the last call's end.

A ``--trace 1`` run reports only per-layer metrics, so its window is the
shortest one: a single pass, or a single call a pool batch; the traced
slice follows it.

The program is ``npswf_tpu_torch``, reached through its module attributes
at call time (``pipeline.process_batch``, ``executor.run_segment``), so a
test can put a broken path underneath. The reference (``reference/``) runs
after the window, on the answers a seed-drawn sample picks.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from wfbench import compare, generate, profile, roofline, spec
from wfbench.reference import pipeline as ref_pipeline
from wfbench.reference import segment as ref_segment
from wfbench.spec import Cell, Geometry

FORBIDDEN = ("jax", "jaxlib", "flax", "npswf_tpu")
SAMPLE = 4   # the seed's stream that draws the answers compared


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``npswf_tpu_torch`` is not ``npswf_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, by
    ``statistics.quantiles(method="inclusive")``."""
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method="inclusive")[
        int(round(q)) - 1])


def rate(units: float, start: float, end: float) -> float:
    """Work over the whole window."""
    return units / (end - start)


def torch_dtype(name: str):
    import torch
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}[name]


def npsconfig(fields: dict):
    from npswf_tpu_torch.core.config import NPSConfig
    return NPSConfig.from_json(json.dumps(fields))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(out) -> Dict[str, np.ndarray]:
    """A PipelineOutput's fields as host arrays."""
    return {k: v.detach().cpu().numpy() for k, v in out._asdict().items()}


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    units: int = 0              # blocks handed to the entry
    attempted: int = 0          # events
    failed: int = 0
    call_s: List[float] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)


# ----------------------------------------------------------------------
# process_batch
# ----------------------------------------------------------------------
class BatchEntry:
    """The pool of batches on the device and the calls over it."""

    def __init__(self, fields: dict, data: dict, dev, dtype_name: str):
        import torch
        from npswf_tpu_torch.core.calibration import CalibrationBundle
        from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
        self.dev = dev
        self.cfg = npsconfig(dict(fields, compute_dtype=dtype_name))
        dtype = torch_dtype(dtype_name)
        cal = CalibrationBundle(**data["calibration"])
        self.calib = calib_to_torch(cal.device_arrays(self.cfg), dev, dtype)
        self.pool = [batch_to_torch(s, p, c, dev, dtype)
                     for s, p, c in data["batches"]]
        self.latest: List = [None] * len(self.pool)
        # running sums on the card over the window's calls, read once after
        # it: fits that succeeded and failed, events with a dropped lane
        self.fits = torch.zeros(2, dtype=torch.int64, device=dev)
        self.dropped = torch.zeros((), dtype=torch.int64, device=dev)

    def call(self, i: int):
        from npswf_tpu_torch.engine import pipeline
        return pipeline.process_batch(self.cfg, self.calib, self.pool[i])

    def warm_up(self) -> None:
        for i in range(len(self.pool)):
            self.call(i)
        _sync(self.dev)

    def window(self, seconds: float) -> Window:
        import torch
        E, B = self.pool[0].signal.shape[:2]
        w = Window()
        n = 0
        w.start = time.perf_counter()
        while True:
            i = n % len(self.pool)
            t0 = time.perf_counter()
            try:
                out = self.call(i)
                _sync(self.dev)
            except Exception:               # an answer that never comes
                w.errors.append(traceback.format_exc())
                w.failed += E
                out = None
            t1 = time.perf_counter()
            w.call_s.append(t1 - t0)
            self.latest[i] = out
            if out is not None:
                self.fits += torch.stack((out.n_fit_success,
                                          out.n_fit_failure))
                self.dropped += out.search_overflow.any(dim=-1).sum()
            n += 1
            w.units += E * B
            w.attempted += E
            w.end = t1
            # every batch of the pool answers at least once
            if t1 - w.start >= seconds and n >= len(self.pool):
                break
        return w

    def failed_lanes(self) -> int:
        """Events of the window's calls with a lane the search capacity
        dropped."""
        return int(self.dropped)

    def fit_counts(self) -> Dict[str, int]:
        success, failure = (int(v) for v in self.fits.cpu())
        return {"success": success, "failure": failure}

    def traced(self, calls: int):
        """``calls`` calls under the profiler, each in a host span, keeping
        no output (so the allocator stays as the window left it); returns
        the reduced trace and, for each call, its pool index and the
        pulse counts and iterations of that batch's answer in the window
        (every call of one batch answers alike)."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("wfbench.slice"):
                for n in range(calls):
                    with torch.profiler.record_function("wfbench.process_batch"):
                        self.call(n % len(self.pool))
                        _sync(self.dev)
        trace = profile.reduce(prof, "wfbench.slice")
        host = {}
        for i in {n % len(self.pool) for n in range(calls)}:
            o = self.latest[i]
            if o is not None:
                host[i] = {"wfnpulse": o.wfnpulse.cpu().numpy(),
                           "fit_n_iter": o.fit_n_iter.cpu().numpy()}
        return trace, [(n % len(self.pool), host[n % len(self.pool)])
                       for n in range(calls) if n % len(self.pool) in host]

    def answers(self, indices) -> Dict[int, Optional[Dict[str, np.ndarray]]]:
        return {i: (None if self.latest[i] is None else _host(self.latest[i]))
                for i in indices}


# ----------------------------------------------------------------------
# run_segment
# ----------------------------------------------------------------------
class SegmentEntry:
    """Passes of ``run_segment`` over the cell's raw segment."""

    def __init__(self, fields: dict, data: dict, traffic: dict, dev,
                 tmpdir: str):
        from npswf_tpu_torch.core.calibration import CalibrationBundle
        from npswf_tpu_torch.io.rawstream import RawSegment
        from npswf_tpu_torch.utils.timers import StageTimer
        self.dev = dev
        self.cfg = npsconfig(fields)
        self.cal = CalibrationBundle(**data["calibration"])
        self.seg = RawSegment(**data["segment"], payload={})
        self.t = traffic
        self.tmpdir = tmpdir
        self.timers = StageTimer()
        self.kept: Optional[str] = None     # the last pass's directory

    def one_pass(self, seg, timers):
        from npswf_tpu_torch.runtime import executor
        d = tempfile.mkdtemp(prefix="wfbench_pass_", dir=self.tmpdir)
        try:
            res = executor.run_segment(
                self.cfg, self.cal, seg, os.path.join(d, "wf.npz"),
                batch_size=self.t["batch_size"], timers=timers,
                chain_batches=self.t["chain_batches"],
                compress_output=self.t["compress_output"], device=self.dev)
        except BaseException:
            shutil.rmtree(d, ignore_errors=True)
            raise
        return res, d

    def warm_up(self) -> None:
        from npswf_tpu_torch.utils.timers import StageTimer
        n = min(self.seg.n_events, self.t["warm_events"])
        _, d = self.one_pass(self.seg.slice(0, n), StageTimer())
        shutil.rmtree(d, ignore_errors=True)

    def window(self, seconds: float) -> Window:
        E = self.seg.n_events
        w = Window()
        w.start = time.perf_counter()
        while True:
            try:
                res, d = self.one_pass(self.seg, self.timers)
            except Exception:
                w.errors.append(traceback.format_exc())
                w.failed += E
            else:
                if self.kept:
                    shutil.rmtree(self.kept, ignore_errors=True)
                self.kept = d
                w.failed += (res.n_bad_slot + res.n_oversize + res.n_truncated
                             + min(E, res.n_search_dropped))
            t1 = time.perf_counter()
            w.call_s.append(t1 - (w.end or w.start))
            w.end = t1
            w.units += E * self.cfg.nblocks
            w.attempted += E
            if t1 - w.start >= seconds:
                break
        return w

    def traced(self):
        """One pass under the profiler in a host span."""
        import torch
        from npswf_tpu_torch.utils.timers import StageTimer
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("wfbench.segment_pass"):
                _, d = self.one_pass(self.seg, StageTimer())
                _sync(self.dev)
        shutil.rmtree(d, ignore_errors=True)
        return profile.reduce(prof, "wfbench.segment_pass")

    def wf_file(self) -> Optional[Dict[str, np.ndarray]]:
        if not self.kept:
            return None
        with np.load(os.path.join(self.kept, "wf.npz")) as z:
            return {k: z[k] for k in z.files}

    def close(self) -> None:
        if self.kept:
            shutil.rmtree(self.kept, ignore_errors=True)
            self.kept = None


# ----------------------------------------------------------------------
# the comparison with the reference
# ----------------------------------------------------------------------
def sample(seed: int, n: int, k: int, extra: Optional[int] = None) -> List[int]:
    """k of n indices drawn from the seed, plus ``extra``."""
    rng = np.random.default_rng(generate.seed_key(seed, SAMPLE))
    picked = sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                                 replace=False))
    if extra is not None and extra not in picked:
        picked.append(int(extra))
    return picked


def reference_batch(g: Geometry, data: dict, i: int, dtype_name: str, dev):
    s, p, c = data["batches"][i]
    return ref_pipeline.process_batch(g, data["calibration"], s, p, c,
                                      torch_dtype(dtype_name), dev)


def check_batches(g: Geometry, data: dict, answers: dict, dtype_name: str,
                  dev) -> (Dict[str, float], Optional[str]):
    """The numbers over the sampled calls' answers (None: never came)."""
    readings = []
    missing = None
    for i, got in answers.items():
        if got is None:
            missing = f"the answer of pool batch {i} never came"
            continue
        readings.append(compare.compare(
            got, reference_batch(g, data, i, dtype_name, dev), g.dt))
    if not readings:
        return {k: float("inf") for k in compare.NUMBERS}, missing
    return compare.merge(readings), missing


def reference_segment_batch(g: Geometry, data: dict, lo: int, hi: int,
                            dtype_name: str, dev):
    """The reference decode of events [lo, hi) and its pipeline outputs as
    the WF file holds them."""
    dec = ref_segment.decode(g, data["calibration"], data["segment"], lo, hi)
    out = ref_pipeline.process_batch(
        g, data["calibration"], dec["signal"], dec["pres"][:, :g.nblocks],
        dec["corr_time_HMS"], torch_dtype(dtype_name), dev,
        minsignal=dec["minsignal"])
    return dec, compare.as_written(out)


def check_segment(g: Geometry, data: dict, wf, batches: List[int], E: int,
                  dtype_name: str, dev):
    if wf is None:
        return ({k: float("inf") for k in compare.SEGMENT_NUMBERS},
                "no pass of the window wrote its WF file")
    n = data["segment"]["evt"].shape[0]
    readings = []
    for b in batches:
        lo, hi = b * E, min(n, (b + 1) * E)
        dec, ref = reference_segment_batch(g, data, lo, hi, dtype_name, dev)
        # the file's rows of these events, by their event numbers
        order = np.argsort(wf["evt"], kind="stable")
        rows = order[np.searchsorted(wf["evt"][order], dec["evt"])]
        got = compare.wf_rows(wf, rows, g.nblocks, g.maxwfpulses)
        r = compare.compare(got, ref, g.dt)
        r["columns_unequal"] = float(compare.columns_unequal(
            wf, rows, dec, g.nblocks))
        readings.append(r)
    numbers = compare.merge(readings)
    # every event of the segment in the file, once
    numbers["events_unequal"] = float(compare.events_unequal(
        np.asarray(wf["evt"]), data["segment"]["evt"]))
    return numbers, None


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------
def card_line() -> str:
    import subprocess
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "nvidia-smi not found"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "?"


def device_info(dev, chips: int, peak: int) -> dict:
    import torch
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak)}


def free_device() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float, workers: Optional[int] = None,
        tmpdir: Optional[str] = None, log=sys.stderr) -> dict:
    """One run; returns the result line's object (keys: correct, attempted,
    failed, metrics, device, [breakdown], card, checks)."""
    import torch
    from npswf_tpu_torch import kernels
    t = cell.traffic
    g = cell.geometry
    dtype_name = cell.dtype_name
    marks = [("start", t_start), ("imports", time.perf_counter())]
    card = card_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        kernels.library()
    marks.append(("library", time.perf_counter()))
    data = generate.make_traffic(cell.fields, t, seed, workers=workers)
    marks.append(("traffic", time.perf_counter()))
    tmpdir = tmpdir or tempfile.gettempdir()
    segment = t["entry"] == "run_segment"
    if segment:
        entry = SegmentEntry(cell.fields, data, t, dev, tmpdir)
    else:
        entry = BatchEntry(cell.fields, data, dev, dtype_name)
    marks.append(("upload", time.perf_counter()))
    entry.warm_up()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = ", ".join(f"{n} {b - a:.2f}" for (_, a), (n, b)
                      in zip(marks, marks[1:]))
    print(f"[wfbench] {cell.name} seed {seed}: set-up {setup_s:.3f} s "
          f"({parts}) ({card})", file=log, flush=True)

    # a traced run reports no end-to-end metric: its window is one pass
    # over the segment or one call a pool batch, which feeds the readers of
    # the program's spans and counters and the comparison, and then the
    # traced slice
    w = entry.window(0.0 if trace else seconds)
    window_s = w.end - w.start
    for err in w.errors[:1]:
        print(f"[wfbench] error in the window:\n{err}", file=log)
    ctx = SimpleNamespace(cell=cell, geometry=g, dtype=dtype_name,
                          roofline=roofline, window_s=window_s,
                          calls=len(w.call_s), trace=None, traced_outputs=[],
                          traced_calls=0, timers=None, fit=None,
                          pool_pres=None)
    if segment:
        ctx.timers = {k: list(v) for k, v in entry.timers.samples.items()}
    else:
        w.failed += entry.failed_lanes()
        ctx.fit = entry.fit_counts()
        ctx.pool_pres = [p for _, p, _ in data["batches"]]
    if trace:
        if segment:
            ctx.trace = entry.traced()
            ctx.traced_calls = 1
        else:
            ctx.trace, ctx.traced_outputs = entry.traced(t["trace_calls"])
            ctx.traced_calls = len(ctx.traced_outputs)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                continue
            if m["name"] in ("segment_blocks_per_s", "batch_blocks_per_s"):
                v = rate(w.units, w.start, w.end)
            elif m["name"] == "batch_p95_ms":
                v = 1e3 * percentile(w.call_s, 95)
            else:
                raise ValueError(f"no measure for {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- correct: the sampled answers against the reference --------
    t_check = time.perf_counter()
    if segment:
        wf = entry.wf_file()
        entry.close()
        del entry
        free_device()
        E = t["batch_size"]
        nb = -(-t["events"] // E)
        numbers, missing = check_segment(
            g, data, wf, sample(seed, nb, t["check_batches"]), E, dtype_name,
            dev)
    else:
        slowest = int(np.argmax(w.call_s)) % len(entry.pool)
        picked = sample(seed, len(entry.pool), t["check_calls"], slowest)
        answers = entry.answers(picked)
        del entry
        free_device()
        numbers, missing = check_batches(g, data, answers, dtype_name, dev)
    correct, rows = compare.verdict(numbers, cell.limits, missing)
    if missing:
        print(f"[wfbench] {missing}", file=log)
    print(f"[wfbench] reference check {time.perf_counter() - t_check:.1f} s",
          file=log)
    out = {"correct": bool(correct and not w.errors),
           "attempted": w.attempted, "failed": w.failed, "metrics": metrics,
           "device": device_info(dev, cell.chips, peak)}
    if trace:
        out["device"]["busy_s"] = ctx.trace.busy_us * 1e-6
        out["device"]["window_s"] = ctx.trace.span_us * 1e-6
        out["breakdown"] = profile.breakdown(ctx.trace)
    out["card"] = card
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=log)
    return out

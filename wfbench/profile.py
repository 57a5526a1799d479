"""The reduction of a ``torch.profiler`` trace to what the per-layer
readers and the ``breakdown`` need.

``reduce(prof, span_name)`` keeps, in microseconds on the profiler's clock:

- ``device``: every device activity (kernel, copy, set) as (name, start,
  end, stream);
- ``runtime``: the count of each CUDA runtime call the host made;
- ``span``: (start, end) of the benchmark's own host span ``span_name``
  around the traced calls;
- ``busy_us``: the union of the device activities on every stream;
- ``gaps``: the device's idle intervals inside the span, each named by the
  innermost host operation that covered its middle, on any thread (the
  benchmark's own spans, ``wfbench.*``, when no operation of the program
  did).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# CUDA runtime calls that make the host wait for the card (trace.py's)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
GAP_FLOOR_US = 5.0     # gaps shorter than this are summed under one name


@dataclass
class Trace:
    device: List[Tuple[str, float, float, int]] = field(default_factory=list)
    runtime: Dict[str, int] = field(default_factory=dict)
    span: Tuple[float, float] = (0.0, 0.0)
    busy_us: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def span_us(self) -> float:
        return self.span[1] - self.span[0]

    def kernels(self, fragment: str = ""):
        """Device kernels (no copies or sets) whose name holds ``fragment``."""
        return [d for d in self.device
                if fragment in d[0] and not d[0].startswith(NOT_KERNELS)]

    def syncs(self) -> int:
        return sum(self.runtime.get(k, 0) for k in SYNC_CALLS)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    base = name.split("(")[0] if "(" in name else name
    return base[:width]


def reduce(prof, span_name: str) -> Trace:
    """The trace of a ``torch.profiler.profile``: its events as
    ``reduce_events`` takes them. Ranges the host marked
    (``record_function``, the program's or the benchmark's) also appear on
    the device's timeline as user annotations; they are no device work
    and are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in prof.events():
        on_device = e.device_type == cuda
        if on_device and (getattr(e, "is_user_annotation", False)
                          or e.name.startswith("wfbench.")):
            continue
        tr = e.time_range
        events.append((on_device, e.name, tr.start, tr.end,
                       e.device_resource_id if on_device else e.thread))
    return reduce_events(events, span_name)


def reduce_events(events, span_name: str) -> Trace:
    """``events``: (on_device, name, start_us, end_us, stream or thread)."""
    device, host = [], defaultdict(list)
    runtime: Dict[str, int] = defaultdict(int)
    spans = []
    for on_device, name, start, end, where in events:
        if on_device:
            if end > start:
                device.append((name, start, end, where))
            continue
        if name.startswith("cuda"):
            runtime[name] += 1
        if name == span_name:
            spans.append((start, end))
        host[where].append((start, end, name))
    t = Trace(device=device, runtime=dict(runtime))
    if spans:
        t.span = (min(s for s, _ in spans), max(e for _, e in spans))
    elif device:
        t.span = (min(d[1] for d in device), max(d[2] for d in device))
    lo, hi = t.span
    merged = _union([(max(a, lo), min(b, hi)) for _, a, b, _ in device
                     if b > lo and a < hi])
    t.busy_us = sum(b - a for a, b in merged)
    idle = []
    cursor = lo
    for a, b in merged:
        if a > cursor:
            idle.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        idle.append((cursor, hi))
    t.gaps = _name_gaps(idle, host)
    return t


def _nested(evs):
    """A thread's events sorted by start (outer first on ties), their
    starts, ends, names and each one's enclosing event (-1: none)."""
    evs = sorted(evs, key=lambda x: (x[0], -x[1]))
    parent = []
    stack = []
    for i, (s, e, _) in enumerate(evs):
        while stack and evs[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return ([x[0] for x in evs], [x[1] for x in evs], [x[2] for x in evs],
            parent)


def _name_gaps(idle, host) -> List[Tuple[str, float]]:
    """(name, microseconds) of each idle interval: the innermost host event
    on any thread that covers the interval's middle (the shortest, where
    several threads have one)."""
    threads = [_nested(evs) for evs in host.values()]
    named = []
    for a, b in idle:
        if b - a < GAP_FLOOR_US:
            named.append((f"gaps under {GAP_FLOOR_US:g} us", b - a))
            continue
        mid = 0.5 * (a + b)
        best = None
        for starts, ends, names, parent in threads:
            # the last event to start before the middle, or the nearest
            # event enclosing it that still covers the middle
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0 and ends[j] < mid:
                j = parent[j]
            if j >= 0 and (best is None or ends[j] - starts[j] < best[0]):
                best = (ends[j] - starts[j], names[j])
        named.append(((best[1] if best else "no host operation"), b - a))
    return named


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, each summed by name, in seconds."""
    ops: Dict[str, float] = defaultdict(float)
    for name, a, b, _ in t.device:
        ops[short_name(name)] += (b - a) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    for name, us in t.gaps:
        gaps[short_name(name)] += us * 1e-6
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda x: -x[1])[:top]}

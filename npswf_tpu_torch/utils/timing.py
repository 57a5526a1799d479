"""Device timing for the probes: the card's time by CUDA events, the CPU's
by the host clock.

A region is timed from a recorded start to a recorded end on the current
stream, and read after the device has finished it, so the time is the
device's (with the host's launches inside it when the host is the slower
side, as it is for ``process_batch``). On the CPU the same calls return
host-clock seconds.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def probe_config():
    """The probes' configuration: fp32 on the full calorimeter (the tests
    put a small grid in its place)."""
    from npswf_tpu_torch.core.config import NPSConfig
    return NPSConfig(compute_dtype="float32")


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def region_seconds(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds of one call of ``fn``, to the end of its device work."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def device_seconds(fn: Callable[[], object], device: torch.device,
                   reps: int = 5, warmup: int = 1) -> float:
    """The median of ``reps`` timed calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    return statistics.median(region_seconds(fn, device) for _ in range(reps))

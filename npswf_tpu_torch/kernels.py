"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
process a source, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes`` (pointers and the stream
travel as ``c_void_p``). The build runs on first use, goes to
``build/npswf_tpu_torch/`` beside the package, is keyed by a hash of the
sources and flags, and is guarded by an ``fcntl`` lock so concurrent
processes build it once. A missing ``nvcc`` or a failed build raises: there
is no fallback.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code. ``launches`` counts kernel launches by name and
``plain_calls`` counts calls of the plain PyTorch versions, so a run can
show which path it took. ``counts`` holds the layers' own counters, each a
number the host already holds where it is counted: ``process_batch``
calls, the host syncs of the program's own code by site (``sync.<site>``),
the fit ladder's route, lanes and rungs (the rungs' lanes read back with
the batch's diagnostics where K3 runs the ladder), and the WF file
merge's members, those
deflated on its pool and the pool's width (``io.merge.*``).
``count_launch``, ``count_plain`` and
``count`` add to them under a lock: the segment executor runs
``process_batch`` on two threads. Inside ``recording()`` a thread's counts
go to counters of its own instead, and ``add`` adds such counters to the
process's: what a CUDA graph's capture issues runs at its replays
(``engine/graphs.py``).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "npswf_tpu_torch"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the toolkit's default prefix
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

MATCHED_FILTER = "matched_filter"
SEARCH_OPERANDS = "search_operands"
SEARCH_TOPK = "search_topk"
LM_SOLVE = "lm_solve"
FUSED_EVAL = "fused_eval"
FUSED_NEQ = "fused_neq"
FUSED_SYSTEM = "fused_system"
KERNEL_NAMES = (MATCHED_FILTER, SEARCH_OPERANDS, SEARCH_TOPK, LM_SOLVE,
                FUSED_EVAL, FUSED_NEQ, FUSED_SYSTEM)

launches: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()
counts: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
_local = threading.local()      # .recorded: the counters of recording()


def _add(i: int, name: str, n: int) -> None:
    recorded = getattr(_local, "recorded", None)
    if recorded is not None:
        recorded[i][name] += n
        return
    with _count_lock:
        (launches, plain_calls, counts)[i][name] += n


def count_launch(name: str) -> None:
    _add(0, name, 1)


def count_plain(name: str) -> None:
    _add(1, name, 1)


def count(name: str, n: int = 1) -> None:
    _add(2, name, n)


@contextlib.contextmanager
def recording():
    """This thread's launches, plain calls and counters, in three Counters
    of their own (yielded as a tuple) in place of the process's."""
    recorded = (collections.Counter(), collections.Counter(),
                collections.Counter())
    outer = getattr(_local, "recorded", None)
    _local.recorded = recorded
    try:
        yield recorded
    finally:
        _local.recorded = outer


def add(recorded) -> None:
    """Add ``recording()``'s three Counters to the process's."""
    with _count_lock:
        for mine, theirs in zip((launches, plain_calls, counts), recorded):
            mine.update(theirs)


def reset_counts() -> None:
    with _count_lock:
        launches.clear()
        plain_calls.clear()
        counts.clear()


def counts_report() -> str:
    """The three counters since the process started or last reset them,
    one line each, sorted by name."""
    with _count_lock:
        parts = [(title, sorted(c.items())) for title, c in (
            ("kernel launches", launches), ("plain calls", plain_calls),
            ("program counters", counts))]
    return "\n".join(f"{title}: " + (", ".join(f"{k} {v}" for k, v in items)
                                      or "none")
                     for title, items in parts)


_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
_SIGNATURES = {
    "npswf_matched_filter": [_I] + [_P] * 5 + [_I] * 6 + [_P],
    "npswf_search": [_I] + [_P] * 7 + [_I] * 10 + [_D] * 5 + [_P],
    "npswf_search_layout": [_I] * 5,
    "npswf_lm_max_pulses": [_I, _I],
    "npswf_lm_solve": [_I, _I, _P, _P] + [_I] * 6 + [_D] * 13 + [_P],
    "npswf_fused_eval": [_I] + [_P] * 9 + [_I] * 4 + [_D] * 2 + [_P],
    "npswf_fused_neq": [_I, _I, _P, _P, _I, _I] + [_L] * 3 + [_P],
    "npswf_system_layout": [_I] * 3,
    "npswf_fused_system": [_I, _I, _P, _P, _I, _I, _L, _L, _I] + [_D] * 2
                          + [_P],
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libnpswf_kernels_{h.hexdigest()[:16]}.so"


def _compile_and_link(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    cu, _ = _sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(f), "-o", str(o)]
            for f, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o", str(tmp)]
    log = [" ".join(c) + "\n" + o + e for c, (o, e) in zip(cmds, outs)]
    failed = [(c, p.returncode, e) for c, p, (_, e) in zip(cmds, procs, outs)
              if p.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append((link, res.returncode, res.stderr))
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        c, code, err = failed[0]
        raise RuntimeError(f"nvcc failed ({code}) on {c[-3]}:\n{err[-6000:]}")
    os.replace(tmp, so)


def build() -> Path:
    """Compile csrc/*.cu and link the shared library (once per source
    hash)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                _compile_and_link(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"kernels take float32 or float64, not {dtype}")


def require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape and type on
    ``device`` (what the kernels read through a raw pointer)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

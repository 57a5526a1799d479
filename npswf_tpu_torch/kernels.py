"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (pointers
and the stream travel as ``c_void_p``). The build runs on first use, goes to
``build/npswf_tpu_torch/`` beside the package, is keyed by a hash of the
sources and flags, and is guarded by an ``fcntl`` lock so concurrent
processes build it once. A missing ``nvcc`` or a failed build raises: there
is no fallback.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code. ``launches`` counts kernel launches by name and
``plain_calls`` counts calls of the plain PyTorch versions, so a run can
show which path it took.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "npswf_tpu_torch"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the toolkit's default prefix
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

MATCHED_FILTER = "matched_filter"
SEARCH_OPERANDS = "search_operands"
LM_SOLVE = "lm_solve"
KERNEL_NAMES = (MATCHED_FILTER, SEARCH_OPERANDS, LM_SOLVE)

launches: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()


def reset_counts() -> None:
    launches.clear()
    plain_calls.clear()


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "npswf_matched_filter": [_I] + [_P] * 5 + [_I] * 6 + [_P],
    "npswf_search_scratch_rows": [_I],
    "npswf_search_operands": [_I] + [_P] * 9 + [_I] * 9 + [_D] * 5 + [_P],
    "npswf_lm_supported": [_I],
    "npswf_lm_solve": [_I, _I, _P, _P] + [_I] * 4 + [_D] * 11 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


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


def build() -> Path:
    """Compile csrc/*.cu into the shared library (once per source hash)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                cu, _ = _sources()
                tmp = so.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       *map(str, cu)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                (BUILD_DIR / "build.log").write_text(
                    " ".join(cmd) + "\n" + res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}):\n{res.stderr[-6000:]}")
                os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
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

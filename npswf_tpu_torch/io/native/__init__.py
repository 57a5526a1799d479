"""Native (C++) host library: the raw-stream decoder and the ragged flatten.

Ported from npswf_tpu/io/native/__init__.py. ``decode.cpp`` (a copy of the
JAX package's) is compiled with g++ on first use into
``build/npswf_tpu_torch/`` beside the package, keyed by a hash of the source
and flags, and guarded by an ``fcntl`` lock so concurrent processes build it
once. A missing compiler or a failed build or load raises: the numpy decode
runs only when the caller asks for it (``use_native=False``, the CLI's
``--no-native``).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "npswf_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libnpswf_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile decode.cpp with g++ (once per source hash)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                tmp = so.with_suffix(f".tmp{os.getpid()}.so")
                cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
                try:
                    res = subprocess.run(cmd, capture_output=True, text=True,
                                         timeout=120)
                except OSError as exc:
                    raise RuntimeError(
                        f"the native decoder cannot be built: {exc}") from exc
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed ({res.returncode}) on "
                                       f"{SRC}:\n{res.stderr[-6000:]}")
                os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def load() -> ctypes.CDLL:
    """The loaded native host library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.decode_batch.restype = ctypes.c_int
        lib.decode_batch.argtypes = [
            f64p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            f32p, u8p, f32p, i32p, ctypes.c_int]
        lib.flatten_pulses.restype = None
        lib.flatten_pulses.argtypes = [
            i32p, f64p, f64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            f64p, f64p, i64p]
        _lib = lib
        return _lib

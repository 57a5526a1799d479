# Copied from npswf_tpu/io/merge.py but for merge_parts' column stream and its
# helpers, a port; tests/test_torch_host.py pins the rest there.
"""Streaming ordered merge of WF part files.

The reference merges its temp Snapshot into the final file through ROOT trees,
which stream row-by-row (ref TEST_2.C:1396-1432) — memory stays bounded no
matter the segment size. The in-memory ``WFWriter.ingest_part`` path holds the
whole run's columns at finalize, which is fine for tests but not for a
production segment (~10^5-10^6 events x 1080 blocks of f64 Samp* columns).

This module is the production path: a two-pass merge over the part files that
never holds more than one part's columns at a time.

- pass 1 reads only the small metadata of every part: ``evt``/``runnum``
  (needed for the (runnum, evt) sort index, ref :1410), the ragged offsets,
  counters and histograms, plus each big column's shape/dtype from its .npy
  header inside the part zip (no data read).
- pass 2 reads each part once, in order, and hands each column's chunk to
  that column's member: its .npy header, then its chunks in part order,
  through the member's own DEFLATE stream (the ``zlib`` compressor
  ``zipfile`` uses for ``ZIP_DEFLATED`` at its default level) and CRC. The
  members take their chunks at the same time on a thread pool (``zlib``
  releases the GIL), as wide as the members and the cores this process may
  use; at width 1 they run on the calling thread. A member's compressed
  bytes wait in an unnamed spool file in the parts' directory, so memory is
  one part's columns plus a compressor a member, whatever the run's length.
- the members are then written into the zip in order, each as
  ``ZipFile.open(name, "w", force_zip64=True)`` writes it: a zip64 local
  header and the spooled bytes. Each member's bytes, CRC and sizes are
  those of the serial merge.

The output is byte-compatible with ``np.load`` (same layout as
``WFWriter.finalize``); a test asserts streaming == in-memory results.
"""
from __future__ import annotations

import contextlib
import io
import os
import shutil
import struct
import tempfile
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from numpy.lib import format as npformat

from npswf_tpu_torch import kernels

# members handled specially rather than stream-concatenated on axis 0
_SPECIAL = ("wf_offsets", "h_offsets", "sort_order",
            "h1time_hist", "h2time_hist", "fit_counters")
_CHUNK = 64 << 20  # stream writes in 64 MiB slices


@dataclass
class MergeResult:
    n_events: int
    n_fit_success: int
    n_fit_failure: int
    n_fit_dropped: int
    n_bad_slot: int
    n_oversize: int
    n_truncated: int
    n_high_pulse: int
    n_search_dropped: int


def _npy_meta(zf: zipfile.ZipFile, member: str) -> Tuple[tuple, np.dtype]:
    """Read (shape, dtype) from a .npy member header without loading data."""
    with zf.open(member) as f:
        version = npformat.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = npformat.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = npformat.read_array_header_2_0(f)
    if fortran:
        raise ValueError(f"fortran-order array not supported: {member}")
    return shape, dtype


class _Member:
    """One .npy member of the output: its header and then its data, in the
    order given, through its own compressor (none when stored) into a spool
    file, with the CRC and size of what went in."""

    def __init__(self, name: str, shape: tuple, dtype: np.dtype,
                 compress: bool, spool) -> None:
        self.name = name + ".npy"
        self.dtype = dtype
        self.spool = spool
        self.crc = self.size = 0
        self.compressor = (zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION,
                                            zlib.DEFLATED, -15)
                           if compress else None)
        header = {"descr": npformat.dtype_to_descr(dtype),
                  "fortran_order": False,
                  "shape": tuple(int(s) for s in shape)}
        buf = io.BytesIO()
        try:
            npformat.write_array_header_1_0(buf, header)
        except ValueError:
            buf = io.BytesIO()
            npformat.write_array_header_2_0(buf, header)
        self.feed(buf.getvalue())

    def feed(self, data) -> None:
        """Append raw bytes (or an array's, as ``dtype``, C order)."""
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data, dtype=self.dtype).reshape(-1)
        mv = memoryview(data).cast("B")
        for off in range(0, len(mv), _CHUNK):
            piece = mv[off:off + _CHUNK]
            self.crc = zlib.crc32(piece, self.crc)
            self.size += len(piece)
            self.spool.write(self.compressor.compress(piece)
                             if self.compressor else piece)

    def feed_npy(self, npy: bytes, crc: Optional[int]) -> None:
        """Append the data of a part's .npy member, checked first against
        the part's CRC of it where one is given."""
        if crc is not None and zlib.crc32(npy) != crc:
            raise zipfile.BadZipFile(f"Bad CRC-32 for a part's {self.name}")
        f = io.BytesIO(npy)
        if npformat.read_magic(f) == (1, 0):
            npformat.read_array_header_1_0(f)
        else:
            npformat.read_array_header_2_0(f)
        self.feed(memoryview(npy)[f.tell():])

    def finish(self, data=None) -> None:
        """Append ``data`` if given and end the compressed stream."""
        if data is not None:
            self.feed(data)
        if self.compressor:
            self.spool.write(self.compressor.flush())

    def put(self, zf: zipfile.ZipFile) -> None:
        """Write the member into ``zf`` as ``zf.open(self.name, "w",
        force_zip64=True)`` would have: the same ZipInfo, a zip64 local
        header with the final CRC and sizes, then the spooled bytes."""
        info = zipfile.ZipInfo(self.name)
        info.compress_type = zf.compression
        info.external_attr = 0o600 << 16
        info.CRC, info.file_size = self.crc, self.size
        info.compress_size = self.spool.tell()
        info.header_offset = zf.fp.tell()
        zf.fp.write(info.FileHeader(zip64=True))
        self.spool.seek(0)
        shutil.copyfileobj(self.spool, zf.fp, 1 << 20)
        zf.start_dir = zf.fp.tell()
        zf.filelist.append(info)
        zf.NameToInfo[info.filename] = info


def _part_columns(path: str, names):
    """(name, .npy bytes, CRC) of each column of ``names`` the part file
    holds, in the file's order and one opening of it. A stored member (the
    executor writes its parts stored) is read as it lies, with the CRC its
    worker checks; any other is read through ``zipfile``, checked, and
    given with CRC None."""
    with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
        for info in zf.infolist():
            name = info.filename
            name = name[:-4] if name.endswith(".npy") else name
            if name not in names:
                continue
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    yield name, member.read(), None
                continue
            head = os.pread(f.fileno(), 30, info.header_offset)
            if head[:4] != b"PK\003\004":
                raise zipfile.BadZipFile(f"{path}: bad local header of "
                                         f"{info.filename}")
            n_name, n_extra = struct.unpack("<HH", head[26:30])
            data = os.pread(f.fileno(), info.file_size,
                            info.header_offset + 30 + n_name + n_extra)
            if len(data) != info.file_size:
                raise zipfile.BadZipFile(f"{path}: {info.filename} cut short")
            yield name, data, info.CRC


def merge_parts(part_paths: Sequence[str], out_path: str,
                payload: Optional[Dict[str, np.ndarray]] = None,
                compress: bool = True) -> MergeResult:
    """Merge part files (in given order) into the final WF file, streaming.

    Each part file is read once; its columns' chunks go to their members,
    which DEFLATE them on a thread pool as wide as the members and the
    cores this process may use (at width 1, serially on this thread) into
    spool files in the parts' directory, removed however the merge ends.
    The zip is written after every member has ended, so a failed merge
    raises and leaves no ``out_path`` (nor spool) behind, and the parts in
    place. ``compress=False`` writes ZIP_STORED members (still a valid
    .npz); the final file stays readable by ``np.load`` either way.
    Counters: ``io.merge.members`` (members written), ``io.merge.pooled``
    (of them deflated off this thread), ``io.merge.workers`` (the width)."""
    payload = payload or {}
    if not part_paths:
        # zero-event run: write the full empty schema so downstream readers
        # (plotstats/parity) still find every column
        from npswf_tpu_torch.io.writer import write_empty_wf
        cols = write_empty_wf(out_path, payload)
        kernels.count("io.merge.members", len(cols))
        kernels.count("io.merge.pooled", 0)
        kernels.count("io.merge.workers", 1)
        return MergeResult(n_events=0, n_fit_success=0, n_fit_failure=0,
                           n_fit_dropped=0, n_bad_slot=0, n_oversize=0,
                           n_truncated=0, n_high_pulse=0, n_search_dropped=0)

    # ---- pass 1: metadata ---------------------------------------------
    evts: List[np.ndarray] = []
    runs: List[np.ndarray] = []
    wf_counts: List[np.ndarray] = []
    h_counts: List[np.ndarray] = []
    h1 = h2 = None
    counters = np.zeros(8, np.int64)
    # column -> (total_shape, dtype); order of first appearance
    col_meta: Dict[str, Tuple[list, np.dtype]] = {}
    for p in part_paths:
        z = np.load(p)
        evts.append(np.asarray(z["evt"]))
        runs.append(np.asarray(z["runnum"]))
        wf_counts.append(np.diff(z["wf_offsets"]))
        h_counts.append(np.diff(z["h_offsets"]))
        h1 = z["h1time_hist"] + (0 if h1 is None else h1)
        h2 = z["h2time_hist"] + (0 if h2 is None else h2)
        fc = np.asarray(z["fit_counters"], np.int64)
        counters[:fc.shape[0]] += fc
        with zipfile.ZipFile(p) as zf:
            for member in zf.namelist():
                name = member[:-4] if member.endswith(".npy") else member
                if name in _SPECIAL or name.startswith("payload_"):
                    continue
                shape, dtype = _npy_meta(zf, member)
                if name not in col_meta:
                    col_meta[name] = [list(shape), dtype]
                else:
                    tot, dt = col_meta[name]
                    if tuple(tot[1:]) != tuple(shape[1:]) or dt != dtype:
                        raise ValueError(
                            f"part {p}: column {name} shape/dtype mismatch")
                    tot[0] += shape[0]
        z.close()

    evt = np.concatenate(evts) if evts else np.zeros(0)
    runnum = np.concatenate(runs) if runs else np.zeros(0)
    E = evt.shape[0]

    def offsets_of(counts_list):
        counts = np.concatenate(counts_list) if counts_list else np.zeros(0, np.int64)
        offs = np.zeros(E + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        return offs

    wf_offsets = offsets_of(wf_counts)
    h_offsets = offsets_of(h_counts)
    sort_order = np.lexsort((evt, runnum))

    # ---- pass 2: stream columns ----------------------------------------
    whole = [("wf_offsets", wf_offsets), ("h_offsets", h_offsets),
             ("sort_order", sort_order),
             ("h1time_hist", np.asarray(h1) if h1 is not None
              else np.zeros(0, np.int64)),
             ("h2time_hist", np.asarray(h2) if h2 is not None
              else np.zeros(0, np.int64)),
             ("fit_counters", counters)]
    whole += [(f"payload_{k}", np.asarray(v)) for k, v in payload.items()]
    width = min(len(col_meta) + len(whole), len(os.sched_getaffinity(0)))
    spool_dir = os.path.dirname(os.path.abspath(part_paths[0]))
    method = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
    with contextlib.ExitStack() as stack:
        def member(name, shape, dtype):
            spool = stack.enter_context(tempfile.TemporaryFile(dir=spool_dir))
            return _Member(name, tuple(shape), dtype, compress, spool)
        columns = {name: member(name, shape, dtype)
                   for name, (shape, dtype) in col_meta.items()}
        wholes = [(member(name, arr.shape, arr.dtype), arr)
                  for name, arr in whole]
        # entered last, so it has shut down before a spool closes
        pool = (stack.enter_context(ThreadPoolExecutor(width))
                if width > 1 else None)
        last = {}   # member -> its call on the pool

        def call(m, fn, *args):
            # after m's previous call, so a member's calls keep their order
            # and a member holds one chunk besides the one being read
            if pool is None:
                fn(*args)
                return
            if m in last:
                last.pop(m).result()
            last[m] = pool.submit(fn, *args)

        for p in part_paths:
            for name, npy, crc in _part_columns(p, columns):
                call(columns[name], columns[name].feed_npy, npy, crc)
        for m in columns.values():
            call(m, m.finish)
        for m, arr in wholes:
            call(m, m.finish, arr)
        for f in last.values():
            f.result()
        members = list(columns.values()) + [m for m, _ in wholes]
        try:
            with zipfile.ZipFile(out_path, "w", method,
                                 allowZip64=True) as zf:
                for m in members:
                    m.put(zf)
        except BaseException:
            with contextlib.suppress(FileNotFoundError):
                os.remove(out_path)
            raise
    kernels.count("io.merge.members", len(members))
    kernels.count("io.merge.pooled", len(members) if pool else 0)
    kernels.count("io.merge.workers", width)

    return MergeResult(
        n_events=E,
        n_fit_success=int(counters[0]), n_fit_failure=int(counters[1]),
        n_fit_dropped=int(counters[2]), n_bad_slot=int(counters[3]),
        n_oversize=int(counters[4]), n_truncated=int(counters[5]),
        n_high_pulse=int(counters[6]), n_search_dropped=int(counters[7]))

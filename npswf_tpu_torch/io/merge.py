# Copied from npswf_tpu/io/merge.py; tests/test_torch_host.py pins it there.
"""Streaming ordered merge of WF part files.

The reference merges its temp Snapshot into the final file through ROOT trees,
which stream row-by-row (ref TEST_2.C:1396-1432) — memory stays bounded no
matter the segment size. The in-memory ``WFWriter.ingest_part`` path holds the
whole run's columns at finalize, which is fine for tests but not for a
production segment (~10^5-10^6 events x 1080 blocks of f64 Samp* columns).

This module is the production path: a two-pass merge over the part files that
never materializes more than one part's column at a time.

- pass 1 reads only the small metadata of every part: ``evt``/``runnum``
  (needed for the (runnum, evt) sort index, ref :1410), the ragged offsets,
  counters and histograms, plus each big column's shape/dtype from its .npy
  header inside the part zip (no data read).
- pass 2 opens one output zip member per column and streams each part's chunk
  into it, so peak memory = one part's largest column.

The output is byte-compatible with ``np.load`` (same layout as
``WFWriter.finalize``); a test asserts streaming == in-memory results.
"""
from __future__ import annotations

import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from numpy.lib import format as npformat

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


def _write_member(zf: zipfile.ZipFile, name: str, shape: tuple,
                  dtype: np.dtype, chunks) -> None:
    """Stream-write one .npy zip member from an iterator of ndarray chunks."""
    header = {"descr": npformat.dtype_to_descr(dtype),
              "fortran_order": False, "shape": tuple(int(s) for s in shape)}
    with zf.open(name + ".npy", "w", force_zip64=True) as fp:
        try:
            npformat.write_array_header_1_0(fp, header)
        except ValueError:
            npformat.write_array_header_2_0(fp, header)
        for arr in chunks:
            arr = np.ascontiguousarray(arr, dtype=dtype)
            mv = memoryview(arr).cast("B")
            for off in range(0, len(mv), _CHUNK):
                fp.write(mv[off:off + _CHUNK])


def merge_parts(part_paths: Sequence[str], out_path: str,
                payload: Optional[Dict[str, np.ndarray]] = None,
                compress: bool = True) -> MergeResult:
    """Merge part files (in given order) into the final WF file, streaming.

    ``compress=False`` writes ZIP_STORED members (still a valid .npz) —
    useful when single-core DEFLATE would bottleneck the job; the final
    file stays readable by ``np.load`` either way."""
    payload = payload or {}
    if not part_paths:
        # zero-event run: write the full empty schema so downstream readers
        # (plotstats/parity) still find every column
        from npswf_tpu_torch.io.writer import write_empty_wf
        write_empty_wf(out_path, payload)
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
    def part_chunks(name):
        for p in part_paths:
            z = np.load(p)
            if name in z.files:
                yield z[name]
            z.close()

    method = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
    with zipfile.ZipFile(out_path, "w", method,
                         allowZip64=True) as zf:
        for name, (shape, dtype) in col_meta.items():
            _write_member(zf, name, tuple(shape), dtype, part_chunks(name))
        for name, arr in (
                ("wf_offsets", wf_offsets), ("h_offsets", h_offsets),
                ("sort_order", sort_order),
                ("h1time_hist", np.asarray(h1) if h1 is not None
                 else np.zeros(0, np.int64)),
                ("h2time_hist", np.asarray(h2) if h2 is not None
                 else np.zeros(0, np.int64)),
                ("fit_counters", counters)):
            _write_member(zf, name, arr.shape, arr.dtype, [arr])
        for k, v in payload.items():
            v = np.asarray(v)
            _write_member(zf, f"payload_{k}", v.shape, v.dtype, [v])

    return MergeResult(
        n_events=E,
        n_fit_success=int(counters[0]), n_fit_failure=int(counters[1]),
        n_fit_dropped=int(counters[2]), n_bad_slot=int(counters[3]),
        n_oversize=int(counters[4]), n_truncated=int(counters[5]),
        n_high_pulse=int(counters[6]), n_search_dropped=int(counters[7]))

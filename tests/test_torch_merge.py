"""The port's merge of WF part files against the JAX package's.

``merge_parts`` reads each part file once and DEFLATEs the output's
members on a thread pool as wide as the members and the cores the process
may use (``os.sched_getaffinity``, patched here to set the width). At any
width each member must be what the JAX package's serial merge writes:
name, order, method, CRC, sizes and compressed bytes. The parts are made
by the port's ``WFWriter.finalize(..., compress=False)``, as the executor
makes them, from seeded random columns of the WF schema.
"""
import os
import pathlib
import struct
import zipfile

import numpy as np
import pytest

import npswf_tpu.io.merge as jax_merge
import npswf_tpu_torch.io.merge as merge
from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.io.writer import H1_BINS, H2_BINS, WF_COLUMNS, WFWriter
import tests.torch_threads  # noqa: F401 (one torch thread a process)

CFG = NPSConfig(ncol=10, nlin=12)
B = CFG.nblocks
PER_EVENT = ("enertot", "integtot", "corr_time_HMS", "evt", "runnum")
RAGGED = {"wftime_flat": "wf", "wfampl_flat": "wf",
          "h1time_flat": "h", "h2time_flat": "h"}
PAYLOAD = {"meta": np.array([1.5, 2.5]),
           "branch_x": np.arange(7, dtype=np.int32).reshape(7, 1)}
N_PARTS = {"one": 1, "several": 4}
ALL = 1024   # cores enough for a worker a member


def _values(rng, shape, dtype):
    """Sparse, rounded values: zeros where no pulse, as in a WF file."""
    if np.dtype(dtype).kind in "iu":
        return rng.integers(0, 4, shape).astype(dtype)
    v = np.round(rng.normal(50.0, 20.0, shape), 3)
    return np.where(rng.random(shape) < 0.3, v, 0.0).astype(dtype)


def _write_part(rng, path, n, first_evt, payload=None, deflated=False):
    counts = {"wf": rng.integers(0, 40, n), "h": rng.integers(0, 6, n)}
    part = {}
    for name, dt in WF_COLUMNS.items():
        if name in RAGGED:
            shape = (int(counts[RAGGED[name]].sum()),)
        else:
            shape = (n,) if name in PER_EVENT else (n, B)
        part[name] = _values(rng, shape, dt)
    part["evt"] = rng.permutation(np.arange(first_evt, first_evt + n))
    part["runnum"] = np.full(n, 3000, np.int64)
    for key, c in counts.items():
        part[f"{key}_offsets"] = np.concatenate([[0], np.cumsum(c)])
    part["h1time_hist"] = rng.integers(0, 9, H1_BINS).astype(np.int64)
    part["h2time_hist"] = rng.integers(0, 9, H2_BINS).astype(np.int64)
    part["fit_counters"] = rng.integers(0, 99, 8).astype(np.int64)
    w = WFWriter(CFG, payload=dict(payload or {}))
    w.ingest_part(part)
    w.finalize(str(path), compress=deflated)


def _parts(tmp_path, n_parts, seed=15, deflated=False):
    """Part files of 5-37 events in a parts directory, as the executor
    names them; one carries a payload of its own, which the merge skips.
    The executor writes its parts stored; ``deflated`` writes them
    DEFLATEd."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "wf.npz.parts"
    d.mkdir()
    paths, lo = [], 0
    for i in range(n_parts):
        n = int(rng.integers(5, 38))
        p = d / f"part_{lo:09d}_{lo + n:09d}.npz"
        _write_part(rng, p, n, lo + 1,
                    {"stale": np.ones(3)} if i == 1 else None, deflated)
        paths.append(str(p))
        lo += n
    return paths


@pytest.fixture
def width(monkeypatch):
    """Set the pool's width through the cores the process may use."""
    def set_width(n):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid: set(range(n)))
    return set_width


def _raw(path, info):
    """A member's bytes as stored in the zip (compressed where DEFLATEd)."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)
        n_name, n_extra = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        return f.read(info.compress_size)


def _assert_same_file(ours, ref):
    with zipfile.ZipFile(ours) as zo, zipfile.ZipFile(ref) as zr:
        assert zo.testzip() is None
        assert zo.namelist() == zr.namelist()
        for io_, ir in zip(zo.infolist(), zr.infolist()):
            for attr in ("compress_type", "CRC", "file_size",
                         "compress_size"):
                assert getattr(io_, attr) == getattr(ir, attr), \
                    (io_.filename, attr)
            assert _raw(ours, io_) == _raw(ref, ir), io_.filename
    with np.load(ours) as a, np.load(ref) as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the members carry zipfile's fixed date, so the whole file is equal
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("n_parts", list(N_PARTS))
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("cores", [1, 2, ALL])
def test_merge_equals_the_serial_merge(tmp_path, width, cores, compress,
                                       n_parts):
    paths = _parts(tmp_path, N_PARTS[n_parts])
    ref = str(tmp_path / "ref.npz")
    want = jax_merge.merge_parts(paths, ref, payload=dict(PAYLOAD),
                                 compress=compress)
    width(cores)
    ours = str(tmp_path / "wf.npz")
    got = merge.merge_parts(paths, ours, payload=dict(PAYLOAD),
                            compress=compress)
    assert vars(got) == vars(want)
    _assert_same_file(ours, ref)
    with zipfile.ZipFile(ours) as zf:
        method = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        assert {i.compress_type for i in zf.infolist()} == {method}
    assert sorted(os.listdir(os.path.dirname(paths[0]))) == \
        sorted(os.path.basename(p) for p in paths)


@pytest.mark.parametrize("cores", [1, 2])
def test_merge_of_deflated_parts(tmp_path, width, cores):
    """Parts written DEFLATEd are read through zipfile, to the same file."""
    paths = _parts(tmp_path, 3, deflated=True)
    ref = str(tmp_path / "ref.npz")
    jax_merge.merge_parts(paths, ref, payload=dict(PAYLOAD))
    width(cores)
    ours = str(tmp_path / "wf.npz")
    merge.merge_parts(paths, ours, payload=dict(PAYLOAD))
    _assert_same_file(ours, ref)


@pytest.mark.parametrize("payload", [None, PAYLOAD], ids=["bare", "payload"])
def test_merge_of_no_part_writes_the_empty_schema(tmp_path, width, payload):
    width(ALL)
    ref, ours = str(tmp_path / "ref.npz"), str(tmp_path / "wf.npz")
    want = jax_merge.merge_parts([], ref, payload=payload)
    got = merge.merge_parts([], ours, payload=payload)
    assert vars(got) == vars(want)
    assert got.n_events == 0
    _assert_same_file(ours, ref)


@pytest.mark.parametrize("compress", [True, False])
def test_member_bytes_do_not_depend_on_the_slices(tmp_path, width,
                                                  monkeypatch, compress):
    """The compressor's input cut into slices of a few hundred bytes (not
    64 MiB) gives the same members."""
    paths = _parts(tmp_path, 3, seed=7)
    ref = str(tmp_path / "ref.npz")
    jax_merge.merge_parts(paths, ref, compress=compress)
    monkeypatch.setattr(merge, "_CHUNK", 333)
    width(3)
    ours = str(tmp_path / "wf.npz")
    merge.merge_parts(paths, ours, compress=compress)
    _assert_same_file(ours, ref)


def _fail_on(monkeypatch, method, member="Sampampl.npy", after=1):
    """_Member.<method> raises on its call number ``after`` (0-based) for
    ``member``."""
    real = getattr(merge._Member, method)
    calls = []

    def failing(self, *args):
        if self.name == member:
            calls.append(1)
            if len(calls) > after:
                raise RuntimeError(f"planted fault in {method}")
        return real(self, *args)
    monkeypatch.setattr(merge._Member, method, failing)


@pytest.mark.parametrize("method,after", [("feed_npy", 1), ("finish", 0),
                                          ("put", 0)])
@pytest.mark.parametrize("cores", [1, 4])
def test_a_failing_member_leaves_no_file_behind(tmp_path, width, monkeypatch,
                                                cores, method, after):
    """The exception surfaces from merge_parts; neither the WF file nor a
    spool is left, and the parts stay for a resumed run."""
    paths = _parts(tmp_path, 3)
    before = {p: pathlib.Path(p).read_bytes() for p in paths}
    width(cores)
    _fail_on(monkeypatch, method, after=after)
    out = str(tmp_path / "wf.npz")
    with pytest.raises(RuntimeError, match="planted fault"):
        merge.merge_parts(paths, out, payload=dict(PAYLOAD))
    assert not os.path.exists(out)
    assert sorted(os.listdir(tmp_path)) == ["wf.npz.parts"]
    assert sorted(os.listdir(os.path.dirname(paths[0]))) == \
        sorted(os.path.basename(p) for p in paths)
    assert {p: pathlib.Path(p).read_bytes() for p in paths} == before


@pytest.mark.parametrize("cores", [1, 4])
def test_a_corrupt_part_fails_its_crc(tmp_path, width, cores):
    """A part read as it lies is still checked against its CRC."""
    paths = _parts(tmp_path, 3)
    with zipfile.ZipFile(paths[2]) as zf:
        info = zf.getinfo("chi2.npy")
    with open(paths[2], "r+b") as f:
        f.seek(info.header_offset + 30 + len(info.filename) + 20 + 200)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    width(cores)
    out = str(tmp_path / "wf.npz")
    with pytest.raises(zipfile.BadZipFile, match="chi2"):
        merge.merge_parts(paths, out)
    assert not os.path.exists(out)


@pytest.mark.parametrize("cores", [1, 2, ALL])
def test_merge_counters(tmp_path, width, cores):
    paths = _parts(tmp_path, 2)
    width(cores)
    kernels.reset_counts()
    merge.merge_parts(paths, str(tmp_path / "wf.npz"), payload=dict(PAYLOAD))
    with zipfile.ZipFile(tmp_path / "wf.npz") as zf:
        n = len(zf.namelist())
    w = min(n, cores)
    assert kernels.counts["io.merge.members"] == n
    assert kernels.counts["io.merge.pooled"] == (n if w > 1 else 0)
    assert kernels.counts["io.merge.workers"] == w


def test_merge_holds_one_chunk_a_member(tmp_path, width, monkeypatch):
    """With slow workers, the reading thread holds no more than one chunk a
    column besides the one it has just read: memory is one part's columns,
    whatever the number of parts."""
    import threading
    import time
    paths = _parts(tmp_path, 6)
    held, peak, lock = [0], [0], threading.Lock()
    real_columns, real_feed = merge._part_columns, merge._Member.feed_npy

    def columns(path, names):
        for item in real_columns(path, names):
            with lock:
                held[0] += 1
                peak[0] = max(peak[0], held[0])
            yield item

    def feed_npy(self, npy, crc):
        time.sleep(0.002)
        real_feed(self, npy, crc)
        with lock:
            held[0] -= 1
    monkeypatch.setattr(merge, "_part_columns", columns)
    monkeypatch.setattr(merge._Member, "feed_npy", feed_npy)
    width(4)
    merge.merge_parts(paths, str(tmp_path / "wf.npz"))
    n_columns = len(WF_COLUMNS)
    assert held[0] == 0
    assert 1 < peak[0] <= n_columns + 1


def test_merge_under_thread_switches(tmp_path, width, monkeypatch):
    """More workers than cores, switching threads every microsecond, with
    the compressors fed a few hundred bytes a call: the file is still the
    serial merge's."""
    import sys
    paths = _parts(tmp_path, 6, seed=3)
    ref = str(tmp_path / "ref.npz")
    jax_merge.merge_parts(paths, ref, payload=dict(PAYLOAD))
    monkeypatch.setattr(merge, "_CHUNK", 333)
    width(ALL)
    ours = str(tmp_path / "wf.npz")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        merge.merge_parts(paths, ours, payload=dict(PAYLOAD))
    finally:
        sys.setswitchinterval(interval)
    _assert_same_file(ours, ref)

"""The search-lane compaction (``search_capacity``) of the port on the CPU,
at the sparse-readout configuration ``nps_rg1a_searchcap_fp32`` of the
benchmark cut to 8 events, its capacity scaled with it to N / 8 lanes.

``process_batch`` is held to the benchmark's frozen reference
(``wfbench/reference/pipeline.py``) at the cell's occupancy, with the
capacity above the present lanes and below them (the present lanes past it
dropped alike on both sides); its counters ``engine.search_lanes`` and
``fit.launched_lanes``, its span ``engine.search.compact`` and the reader
``fit.active_lanes_pct`` are checked against counts made here.
"""
import contextlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import npswf_tpu_torch.engine.pipeline as pipeline
from npswf_tpu_torch import kernels
from npswf_tpu_torch.utils.timers import span
from wfbench import generate, harness, spec
from wfbench.spec import Geometry
import tests.torch_threads  # noqa: F401 (one torch thread a process)

CELL = "searchcap_fp32.batch_sparse"
EVENTS = 8
SEED = 2 ** 31 + 77
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cell():
    return spec.cell(CELL)


def _cut(cell, **fields):
    """The cell's configuration and traffic at EVENTS events, one batch,
    the capacity scaled to N / 8 unless ``fields`` sets it."""
    g = cell.geometry
    cap = cell.fields["search_capacity"] * EVENTS // cell.traffic[
        "events_per_call"]
    assert cap == EVENTS * g.nblocks // 8
    f = dict(cell.fields, **dict(dict(search_capacity=cap), **fields))
    t = dict(cell.traffic, events_per_call=EVENTS, pool=1)
    return f, generate.make_traffic(f, t, SEED, workers=1)


def _run(fields, data):
    """One process_batch call on the CPU: the answer, the counters it adds
    and its spans, each as (name, the names of the spans it lies in)."""
    entry = harness.BatchEntry(fields, data, CPU, fields["compute_dtype"])
    spans, open_ = [], []

    @contextlib.contextmanager
    def recorded(name, timers=None):
        spans.append((name, tuple(open_)))
        open_.append(name)
        try:
            with span(name, timers):
                yield
        finally:
            open_.pop()
    kernels.reset_counts()
    pipeline.span = recorded
    try:
        out = entry.call(0)
    finally:
        pipeline.span = span
    counts = dict(kernels.counts)
    kernels.reset_counts()
    entry.latest[0] = out
    return entry, out, counts, spans


@pytest.fixture(scope="module")
def at_capacity(cell):
    fields, data = _cut(cell)
    return (fields, data) + _run(fields, data)


def _present(data):
    return np.asarray(data["batches"][0][1], bool).reshape(-1)


def test_the_cut_keeps_the_cells_shape(cell, at_capacity):
    """8 events of 1,080 blocks at 5% occupancy: the present lanes sit
    below N / 8, and the pool batch is float32 as the configuration
    states."""
    fields, data, entry, out, _, _ = at_capacity
    N = EVENTS * cell.geometry.nblocks
    assert entry.pool[0].signal.dtype == torch.float32
    assert out.wftime.dtype == torch.float32
    assert 0 < _present(data).sum() < fields["search_capacity"] < N
    assert int(out.n_search_dropped) == 0
    assert not bool(out.search_overflow.any())


@pytest.mark.parametrize("below", [False, True],
                         ids=["capacity_n_over_8", "below_present"])
def test_process_batch_equals_the_reference(cell, at_capacity, below):
    """Every number of ``correct`` reads 0 against the frozen reference,
    above the present lanes and below them, where the lanes past the
    capacity are the same lanes on both sides."""
    if below:
        present = int(_present(at_capacity[1]).sum())
        fields, data = _cut(cell, search_capacity=present * 2 // 3)
        entry, out, _, _ = _run(fields, data)
        dropped = _present(data) & (np.cumsum(_present(data))
                                    > fields["search_capacity"])
        assert dropped.sum() == present - fields["search_capacity"] > 0
        assert np.array_equal(out.search_overflow.numpy().reshape(-1),
                              dropped)
        assert int(out.n_search_dropped) == dropped.sum()
    else:
        fields, data, entry, out, _, _ = at_capacity
    numbers, missing = harness.check_batches(
        Geometry(fields), data, entry.answers([0]), fields["compute_dtype"],
        CPU)
    assert missing is None
    assert set(numbers) >= set(cell.limits)
    assert all(v == 0 for v in numbers.values()), numbers


def _buckets(cfg_fields, out, present):
    """The fit's non-empty pulse-count buckets, counted from the answer:
    (active lanes, capacity) each."""
    npulse = out.wfnpulse.numpy().reshape(-1)
    active = present & out.gate.numpy().reshape(-1) & (npulse > 0)
    Ps = cfg_fields["fit_small_pulses"]
    Pm = cfg_fields["fit_mid_pulses"]
    N = npulse.size
    cap_all = cfg_fields["fit_capacity"] or N
    cap_big = N if not cfg_fields["fit_capacity"] else max(
        min(N, 256), cap_all // cfg_fields["fit_big_frac"])
    masks = [(active & (npulse <= Ps), cap_all),
             (active & (npulse > Ps) & (npulse <= Pm), cap_big),
             (active & (npulse > Pm), cap_big)]
    return [(int(m.sum()), c) for m, c in masks if m.any()]


@pytest.mark.parametrize("fit_capacity", [0, 512], ids=["in_place",
                                                         "capped"])
def test_counters_count_the_lanes_handed_on(cell, at_capacity,
                                            fit_capacity):
    """engine.search_lanes is the capacity; fit.launched_lanes is N for
    each non-empty bucket fitted in place and its capacity for a capped
    one; fit.stage1_lanes the lanes fitted."""
    if fit_capacity:
        fields, data = _cut(cell, fit_capacity=fit_capacity)
        _, out, counts, _ = _run(fields, data)
    else:
        fields, data, _, out, counts, _ = at_capacity
    N = EVENTS * cell.geometry.nblocks
    buckets = _buckets(fields, out, _present(data))
    assert buckets
    assert counts["engine.search_lanes"] == fields["search_capacity"]
    # the compactions make no sync: one read of the bucket sizes a call
    assert {k for k in counts if k.startswith("sync.engine.")} == {
        "sync.engine.bucket_sizes"}
    assert counts["sync.engine.bucket_sizes"] == 1
    if fit_capacity:
        assert counts["fit.launched_lanes"] == sum(c for _, c in buckets)
    else:
        assert counts["fit.launched_lanes"] == N * len(buckets)
    assert counts["fit.stage1_lanes"] == sum(min(n, c) for n, c in buckets)


def _compactions(spans):
    """The engine.search.compact spans, each checked to lie inside the
    search of the call."""
    inner = [within for name, within in spans
             if name == "engine.search.compact"]
    for within in inner:
        assert within == ("engine.process_batch", "engine.search")
    return inner


def test_compaction_is_two_spans_inside_the_search(at_capacity):
    """The compaction is two engine.search.compact spans inside
    engine.search: the gathers in, the gathers back."""
    assert len(_compactions(at_capacity[-1])) == 2


def test_without_a_capacity_the_search_takes_every_lane(cell):
    """search_capacity 0: every lane searched, no compaction and no span
    of it."""
    fields, data = _cut(cell, search_capacity=0)
    _, out, counts, spans = _run(fields, data)
    assert counts["engine.search_lanes"] == EVENTS * cell.geometry.nblocks
    assert {k for k in counts if k.startswith("sync.engine.")} == {
        "sync.engine.bucket_sizes"}
    assert int(out.n_search_dropped) == 0
    assert _compactions(spans) == []


def test_active_lanes_reader_on_the_counts(at_capacity):
    """fit.active_lanes_pct is 100 x fit.stage1_lanes / fit.launched_lanes
    of the program's counters; nothing where fit.launched_lanes is
    absent."""
    read = spec.load_reader("fit.active_lanes_pct")
    counts = at_capacity[4]
    ctx = SimpleNamespace()
    kernels.reset_counts()
    try:
        assert read(ctx) is None
        kernels.count("fit.stage1_lanes", counts["fit.stage1_lanes"])
        assert read(ctx) is None            # a program without the counter
        kernels.count("fit.launched_lanes", counts["fit.launched_lanes"])
        got = read(ctx)
    finally:
        kernels.reset_counts()
    want = 100.0 * counts["fit.stage1_lanes"] / counts["fit.launched_lanes"]
    assert got == pytest.approx(want)
    # the cell's sparse readout: about its 5% occupancy of the lanes fitted
    assert 2.0 < got < 10.0


def test_active_lanes_reader_reads_nothing_without_counters(monkeypatch):
    """A kernels module with launches and plain calls only, and no
    counters at all: the reader leaves its metric out."""
    monkeypatch.delattr(kernels, "counts")
    assert spec.load_reader("fit.active_lanes_pct")(SimpleNamespace()) is None


def test_the_cell_loads_its_files(cell):
    """spec.cell finds the configuration, the mix, the limits and the
    readers; the configuration is nps_rg1a_fp32's with the port's sparse
    capacity for the users' 64-event batch."""
    assert cell.chips == 1 and cell.config_name == "nps_rg1a_searchcap_fp32"
    assert cell.traffic_name == "batch_sparse"
    t = cell.traffic
    assert t["entry"] == "process_batch" and t["sparse_readout"] is True
    assert (t["events_per_call"], t["pool"], t["occupancy"]) == (64, 8, 0.05)
    g = cell.geometry
    assert cell.fields["search_capacity"] == max(
        1024, t["events_per_call"] * g.nblocks // 8) == 8640
    base = spec.config_fields("nps_rg1a_fp32")
    assert {k for k in base if base[k] != cell.fields[k]} == {
        "search_capacity"}
    assert set(base) == set(cell.fields)
    assert cell.limits == {"decisions_pct": 1.0, "time_gap_bins": 0.001,
                           "ampl_gap_rel": 1e-4, "chi2_gap_rel": 1e-3,
                           "diag_gap_rel": 1e-5}
    names = {m["name"] for m in cell.end_to_end}
    assert names == {"setup_s", "batch_blocks_per_s", "batch_p95_ms"}
    layer = {m["name"] for m in cell.per_layer}
    assert "fit.active_lanes_pct" in layer
    dense = {m["name"] for m in spec.cell("fp32.batch_dense").per_layer}
    assert layer == dense
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (c,) = [c for c in bench["configs"] if c["name"] == cell.config_name]
    assert c["reduced"] == []

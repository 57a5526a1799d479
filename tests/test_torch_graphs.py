"""process_batch's graph route and the changes that make it possible, on
the CPU.

On the card a call that ``pipeline.graph_route`` admits runs as two CUDA
graph replays around one read of the bucket sizes (``engine/graphs.py``).
Here a stand-in takes the graph's place: its capture runs the function
once and keeps the tensors it returned, its replay runs it again counting
nothing and writes the answer into those tensors, as a graph writes the
memory its capture left. With it the instance cache, the capture
bookkeeping and the counters are held to the eager body. Besides: the
lane order ``_front`` builds without a host sync, and the one read of the
bucket sizes a call.
"""
import threading

import numpy as np
import pytest
import torch

import npswf_tpu_torch.engine.pipeline as pipeline
from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine import graphs
from npswf_tpu_torch.utils.synthetic import make_events
from tests.test_torch_fit_ladder import _stand_in_card
import tests.torch_threads  # noqa: F401 (one torch thread a process)

GRID = dict(ncol=5, nlin=6)
# short LM budgets: the ladder's rungs get lanes and a call stays short
SHORT = dict(GRID, compute_dtype="float64", lm_max_iter_stage1=2,
             lm_stage1_wide=2, lm_max_iter_stage2=2, lm_stage2_wide=2)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


class StandInGraph:
    """A CUDA graph on the CPU: ``capture`` runs ``fn`` and keeps its
    answer; ``replay`` runs it again, counting nothing, and writes the
    answer into the kept tensors."""

    def __init__(self):
        self.fn = self.out = None

    def capture(self, fn, pool):
        self.fn = fn
        self.out = fn()
        return self.out

    def pool(self):
        return "pool"

    def replay(self):
        with kernels.recording():
            fresh = self.fn()
        for kept, new in zip(_leaves(self.out), _leaves(fresh)):
            kept.copy_(new)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph route on the CPU: every call admitted, the stand-in for
    the capture, no instance left from elsewhere; yields the instances
    made."""
    made = []
    init = graphs._Instance.__init__

    def counted_init(self, *args):
        init(self, *args)
        made.append(self)
    monkeypatch.setattr(graphs._Instance, "__init__", counted_init)
    monkeypatch.setattr(pipeline, "graph_route", lambda *a, **k: True)
    monkeypatch.setattr(graphs, "new_graph", StandInGraph)
    graphs.clear()
    kernels.reset_counts()
    yield made
    graphs.clear()
    kernels.reset_counts()


def _batch(cfg, seed=5, n_events=3, max_pulses=4, pileup=0.6, cal_seed=1):
    cal = synthetic_calibration(cfg, seed=cal_seed)
    truth = make_events(cfg, cal, n_events, occupancy=0.6,
                        max_pulses=max_pulses, pileup_prob=pileup, seed=seed)
    corr = np.random.default_rng(seed).uniform(-2, 2, n_events)
    calib = calib_to_torch(cal.device_arrays(cfg), "cpu", torch.float64)
    return calib, batch_to_torch(truth.signal, truth.pres, corr, "cpu",
                                 torch.float64)


def _equal(a, b):
    """Every field of two PipelineOutputs equal (NaN to NaN)."""
    def same(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            return bool(((x == y) | (x.isnan() & y.isnan())).all())
        return torch.equal(x, y)
    return all(same(getattr(a, f), getattr(b, f))
               for f in pipeline.PipelineOutput._fields)


def _counted(fn):
    """fn()'s answer, and the launches, plain calls and counters it made,
    the call's own and the graphs' counters left out."""
    kernels.reset_counts()
    out = fn()
    counts = {k: v for k, v in kernels.counts.items()
              if k != "engine.process_batch" and not k.startswith("engine.graph")}
    every = dict(kernels.counts)
    got = (dict(kernels.launches), dict(kernels.plain_calls), counts)
    kernels.reset_counts()
    return out, got, every


# ---- the lane order without a sync, and one read of the sizes -------------
@pytest.mark.parametrize("case", ["all true", "all false", "random",
                                  "length 1 true", "length 1 false"])
def test_front_keeps_the_nonzero_order_without_a_sync(case):
    """_front scatters each lane's index to its place (_slot): the order
    the two nonzero calls gave (masked lanes first, each group in index
    order), with no sync counted; _compact's lanes are its head."""
    n = {"length 1 true": 1, "length 1 false": 1}.get(case, 37)
    rng = np.random.default_rng(3)
    mask = torch.as_tensor({"all true": np.ones(n, bool),
                            "all false": np.zeros(n, bool),
                            "random": rng.random(n) < 0.4,
                            "length 1 true": np.ones(1, bool),
                            "length 1 false": np.zeros(1, bool)}[case])
    want = torch.cat([torch.nonzero(mask).squeeze(1),
                      torch.nonzero(~mask).squeeze(1)])
    kernels.reset_counts()
    got = pipeline._front(mask)
    assert not kernels.counts
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(pipeline._front(mask, pipeline._slot(mask)), want)
    cap = max(1, n // 2)
    if cap < n:
        lanes, pos, served = pipeline._compact(mask, cap)
        assert torch.equal(lanes, want[:cap])
        assert torch.equal(served, mask & (pipeline._slot(mask) < cap))
        assert int(pos.max()) <= cap - 1


@pytest.mark.parametrize("fields", [{}, dict(search_capacity=40,
                                             fit_capacity=16)],
                         ids=["in_place", "capped"])
def test_a_call_reads_its_bucket_sizes_once(fields):
    """A call's only syncs besides the CPU's host ladder: one
    sync.engine.bucket_sizes (the capped search and fit lanes compact
    with no sync); fit.stage1_lanes the fitted lanes, at most each
    bucket's capacity; n_fit_dropped what the capacities left."""
    cfg = NPSConfig(**SHORT, **fields)
    calib, batch = _batch(cfg)
    out, (_, _, counts), _ = _counted(
        lambda: pipeline.process_batch(cfg, calib, batch))
    sites = {k: v for k, v in counts.items() if k.startswith("sync.")
             and not k.startswith("sync.fit.")}
    assert sites == {"sync.engine.bucket_sizes": 1}
    N = batch.signal.shape[0] * batch.signal.shape[1]
    npulse = out.wfnpulse.reshape(-1)
    active = ((batch.pres & calib["preswf"][None, :]).reshape(-1)
              & out.gate.reshape(-1) & (npulse > 0))
    if fields:
        # lanes the search did not take have no pulses and are not fitted
        active &= ~out.search_overflow.reshape(-1)
    widths = pipeline._bucket_widths(cfg)
    lo = (0,) + widths[:-1]
    sizes = [int((active & (npulse > a) & (npulse <= b)).sum())
             for a, b in zip(lo, widths)]
    caps = pipeline._bucket_caps(cfg, N)
    assert counts["fit.stage1_lanes"] == sum(map(min, sizes, caps))
    assert int(out.n_fit_dropped) == sum(max(n - c, 0)
                                         for n, c in zip(sizes, caps))
    if fields:
        assert int(out.n_fit_dropped) > 0 and int(out.n_search_dropped) > 0


# ---- the route --------------------------------------------------------------
@pytest.mark.parametrize("case,graphed", [
    ("default", True), ("on the CPU", False), ("plain", False),
    ("block_axis", False), ("reduce_axes", False),
    ("maxwfpulses 24 (host ladder)", False), ("use_fused_system", False),
    ("use_pallas_lm off", False), ("gaussian", False),
    ("fit_capacity", True), ("search_capacity", True)])
def test_the_route_takes_only_calls_the_graphs_serve(case, graphed):
    """The graphs take a call on the card, not plain, off the mesh, whose
    every bucket K3 fits in one launch; CPU lanes, plain, mesh axes, a
    bucket above K3's compiled widths and the generic routes run the eager
    body."""
    fields = {"maxwfpulses 24 (host ladder)": dict(maxwfpulses=24),
              "use_fused_system": dict(use_fused_system=True),
              "use_pallas_lm off": dict(use_pallas_lm=False),
              "gaussian": dict(model_name="gaussian",
                               model_aux=(("width", 3.5),)),
              "fit_capacity": dict(fit_capacity=512),
              "search_capacity": dict(search_capacity=8640)}.get(case, {})
    cfg = NPSConfig(**fields)
    dev = torch.device("cpu" if case == "on the CPU" else "cuda")
    axis = object()       # a mesh rank's axis: the route asks only for one
    kw = {"plain": dict(plain=True), "block_axis": dict(block_axis=axis),
          "reduce_axes": dict(reduce_axes=(axis,))}.get(case, {})
    assert pipeline.graph_route(cfg, dev, **kw) is graphed


# ---- the instances ----------------------------------------------------------
def _threads(n, fn):
    """fn(i) on n threads that are all inside it at once; their answers."""
    barrier = threading.Barrier(n)
    out = [None] * n
    errors = []

    def body(i):
        try:
            barrier.wait(timeout=60)
            out[i] = fn(i)
        except BaseException as e:      # surfaced below
            errors.append(e)
    ts = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    return out


def test_concurrent_callers_hold_one_instance_each_and_passes_reuse_them(
        monkeypatch, stand_in):
    """Two threads inside process_batch at once check out two instances;
    two new threads (the segment's next pass) reuse those two, so nothing
    grows from pass to pass; every answer equals the eager body's."""
    cfg = NPSConfig(**SHORT)
    calib, batch = _batch(cfg)
    ref = pipeline.process_batch_eager(cfg, calib, batch)
    call = graphs._Instance.call
    inside = threading.Barrier(2)

    def both_inside(self, *args):
        inside.wait(timeout=60)
        return call(self, *args)
    monkeypatch.setattr(graphs._Instance, "call", both_inside)
    held = []
    for _ in range(3):        # a pass: two fresh stage workers
        outs = _threads(2, lambda i: pipeline.process_batch(cfg, calib,
                                                            batch))
        assert all(_equal(o, ref) for o in outs)
        held.append({id(inst) for _, inst in graphs._idle})
    assert len(stand_in) == 2
    assert held[0] == held[1] == held[2] == {id(i) for i in stand_in}
    counts = dict(kernels.counts)
    assert counts["engine.process_batch"] == 6
    # each instance: its first call eager, A and one B captured after it
    assert counts["engine.graph_replays"] == 4
    assert counts["engine.graph_captures"] == 4


def test_one_b_a_bucket_pattern_and_answers_never_alias_the_graphs(stand_in):
    """Batches whose buckets with lanes differ (at most 2 pulses a block:
    the narrow one; at most 4: the middle one too) get a B each, captured
    on first use and replayed after; A is captured once; an answer is
    fresh memory, the graphs' outputs untouched by a later call."""
    cfg = NPSConfig(**SHORT)
    calib, two = _batch(cfg, max_pulses=2, pileup=0.0)
    _, four = _batch(cfg, seed=5, max_pulses=4, pileup=0.9)
    refs = {k: pipeline.process_batch_eager(cfg, calib, b)
            for k, b in (("two", two), ("four", four))}
    kernels.reset_counts()
    answers = []
    for name, b in (("two", two), ("two", two), ("four", four),
                    ("two", two), ("four", four)):
        answers.append((name, pipeline.process_batch(cfg, calib, b)))
    (inst,) = stand_in
    assert sorted(inst.b) == [(True, False, False), (True, True, False)]
    assert kernels.counts["engine.graph_captures"] == 3
    assert kernels.counts["engine.graph_replays"] == 4
    kept = {t.data_ptr() for c in inst.b.values() for t in _leaves(c.out)}
    kept |= {t.data_ptr() for t in _leaves(inst.a.out)}
    for name, out in answers:
        assert _equal(out, refs[name]), name
        assert not kept & {t.data_ptr() for t in out}


def test_a_new_calibration_is_copied_in(stand_in):
    """A call with another calibration copies it into the instance (and
    answers as the eager body does with it); the next with the first
    copies that back."""
    cfg = NPSConfig(**SHORT)
    calib, batch = _batch(cfg)
    calib2, _ = _batch(cfg, cal_seed=2)
    want = {1: pipeline.process_batch_eager(cfg, calib, batch),
            2: pipeline.process_batch_eager(cfg, calib2, batch)}
    assert not _equal(want[1], want[2])
    for which, cb in ((1, calib), (1, calib), (2, calib2), (2, calib2),
                      (1, calib)):
        assert _equal(pipeline.process_batch(cfg, cb, batch), want[which])
    (inst,) = stand_in
    assert all(a is calib[k]
               for a, k in zip(inst.calib_src, pipeline.CALIB_KEYS))
    assert kernels.counts["engine.graph_replays"] == 4


@pytest.mark.parametrize("stage3", [False, True], ids=["stage2", "ladder"])
def test_a_replay_counts_what_the_eager_call_counts(monkeypatch, stand_in,
                                                    stage3):
    """With K3's ladder launch stood in for: a replayed call's launches,
    plain calls and counters (fit.stage1_lanes, fit.launched_lanes,
    fit.rungs, fit.retry_lanes, fit.ladder_fused, engine.search_lanes and
    the two syncs) equal the eager body's on the same batch, on batches
    other than the one captured too, and the prime's own counts are the
    eager body's."""
    cfg = NPSConfig(**SHORT, lm_stage3=stage3)
    _stand_in_card(monkeypatch, [])
    calib, first = _batch(cfg, pileup=0.9)
    _, other = _batch(cfg, seed=11, pileup=0.9)
    for n, b in enumerate((first, first, other, first)):
        _, eager, _ = _counted(
            lambda: pipeline.process_batch_eager(cfg, calib, b))
        out, graphed, every = _counted(
            lambda: pipeline.process_batch(cfg, calib, b))
        assert graphed == eager, n
        assert eager[0]["lm_solve"] >= 2
        assert eager[2]["sync.engine.bucket_sizes"] == 1
        assert eager[2]["sync.engine.rung_tallies"] == 1
        assert every.get("engine.graph_replays", 0) == (n > 0)
        assert _equal(out, pipeline.process_batch_eager(cfg, calib, b))


def test_the_replay_share_reads_the_counters():
    """engine.graph_replay_pct is 100 x engine.graph_replays /
    engine.process_batch of the process's counters; nothing where the
    program keeps no engine.graph_replays counter."""
    from wfbench import spec
    read = spec.load_reader("engine.graph_replay_pct")
    kernels.reset_counts()
    assert read(None) is None
    kernels.count("engine.process_batch", 32)
    assert read(None) is None
    kernels.count("engine.graph_replays", 31)
    assert read(None) == 100.0 * 31 / 32
    kernels.reset_counts()

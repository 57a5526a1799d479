"""The port's spans and counters, on the CPU.

``utils.timers.span`` marks the layers' work: a ``StageTimer`` stage where
the caller keeps one and, while ``torch.profiler`` records, a
``record_function`` range ``npswf.<layer>.<stage>``. ``kernels.counts``
holds the layers' counters: ``process_batch`` calls, the program's host
syncs by site and the fit ladder's lanes and rungs. The batches and the
segment here are small (a 6 x 5 grid); stage 1 gets a budget of two
iterations, so that the retry ladder has lanes.
"""
import json
import os

import numpy as np
import pytest
import torch

import npswf_tpu_torch.engine.pipeline as pipeline
from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.fit import lm as tlm
from npswf_tpu_torch.io.rawstream import build_segment
from npswf_tpu_torch.models.waveform import get_model
from npswf_tpu_torch.runtime.executor import run_segment
from npswf_tpu_torch.tools.cli import synth_records
from npswf_tpu_torch.utils.synthetic import make_events
from npswf_tpu_torch.utils.timers import StageTimer, span
import tests.torch_threads  # noqa: F401 (one torch thread a process)

GRID = dict(ncol=5, nlin=6)
# stage 1 stops after two iterations: lanes fail it and climb the ladder
LADDER = dict(GRID, compute_dtype="float64", lm_max_iter_stage1=2,
              lm_stage1_wide=2)
ENGINE = ("search", "gate", "bucket", "resolve", "diagnostics")


def _batch(cfg, n_events=2, seed=3):
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, n_events, occupancy=0.6, max_pulses=4,
                        pileup_prob=0.6, seed=seed)
    corr = np.random.default_rng(seed).uniform(-2, 2, n_events)
    calib = calib_to_torch(cal.device_arrays(cfg), "cpu", torch.float64)
    batch = batch_to_torch(truth.signal, truth.pres, corr, "cpu",
                           torch.float64)
    return calib, batch


def _sync_sites(counts):
    return {k[len("sync."):]: v for k, v in counts.items()
            if k.startswith("sync.")}


def test_process_batch_spans_nest_on_the_profiler_clock():
    """Under torch.profiler a call is one npswf.engine.process_batch range
    around its phases, the fit's stage 1 and its retries, on one thread."""
    cfg = NPSConfig(**LADDER)
    calib, batch = _batch(cfg)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        pipeline.process_batch(cfg, calib, batch)
    ranges = {}
    for e in prof.events():
        if e.name.startswith("npswf."):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end, e.thread))
    (outer,) = ranges.pop("npswf.engine.process_batch")
    names = {f"npswf.engine.{p}" for p in ENGINE} | {"npswf.fit.stage1",
                                                     "npswf.fit.retry"}
    assert names <= set(ranges)
    for name in names:
        for start, end, thread in ranges[name]:
            assert outer[0] <= start <= end <= outer[1], name
            assert thread == outer[2], name
    # the fit runs inside a bucket: three buckets at 12 pulses
    assert len(ranges["npswf.engine.bucket"]) == 3
    buckets = ranges["npswf.engine.bucket"]
    for name in ("npswf.fit.stage1", "npswf.fit.retry"):
        for start, end, _ in ranges[name]:
            assert any(a <= start <= end <= b for a, b, _ in buckets), name


def test_a_span_without_a_profiler_is_the_shared_null_context():
    """Tracing off: no range, one shared null context; a StageTimer given
    to a span gets what timers.stage gives, under the stage's own name."""
    assert span("engine.search") is span("fit.retry")
    with span("engine.search") as got:
        assert got is None
    ours, theirs = StageTimer(), StageTimer()
    for _ in range(3):
        with span("runtime.decode", ours):
            pass
        with theirs.stage("decode"):
            pass
    with pytest.raises(KeyError):
        with span("runtime.fetch", ours):
            raise KeyError("raised inside")
    with pytest.raises(KeyError):
        with theirs.stage("fetch"):
            raise KeyError("raised inside")
    assert set(ours.samples) == set(theirs.samples) == {"decode", "fetch"}
    assert dict(ours.counts) == dict(theirs.counts) == {"decode": 3,
                                                        "fetch": 1}


def test_a_span_under_a_profiler_records_both():
    """Tracing on: the range lands in the trace and the StageTimer still
    records the stage."""
    t = StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("runtime.merge", t):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("npswf.runtime.merge") == 1
    assert t.counts == {"merge": 1}


@pytest.mark.parametrize("stage3", [False, True], ids=["stage2", "ladder"])
def test_ladder_counters_equal_an_independent_count(monkeypatch, stage3):
    """On the CPU the host runs each bucket's ladder (the card's one-launch
    route is in tests/test_torch_fit_ladder.py): fit.stage1_lanes is the
    buckets' lanes; with stage 2 alone fit.retry_lanes is active & ~conv1
    of a direct stage-1 lm_solve of each bucket's inputs. The sync sites
    are the buckets, a ladder test and a select a rung and the generic
    loop's tests; the diagnostics' window is counted on the host."""
    # with the pull-backs, stage 2's budget is one iteration: they run
    cfg = NPSConfig(**LADDER, lm_stage3=stage3,
                    **(dict(lm_max_iter_stage2=1, lm_stage2_wide=1)
                       if stage3 else {}))
    calib, batch = _batch(cfg, seed=5)
    fits = []
    orig = pipeline.fit_waveforms

    def recorded(cfg_, inp, model_name, plain=False):
        fits.append((inp, model_name))
        return orig(cfg_, inp, model_name, plain=plain)
    monkeypatch.setattr(pipeline, "fit_waveforms", recorded)
    kernels.reset_counts()
    out = pipeline.process_batch(cfg, calib, batch)
    counts = dict(kernels.counts)
    kernels.reset_counts()

    fit_active = (batch.pres & calib["preswf"][None, :] & out.gate
                  & (out.wfnpulse > 0))
    assert counts["engine.process_batch"] == 1
    assert counts["fit.ladder_host"] == len(fits)
    assert counts["fit.stage1_lanes"] == int(fit_active.sum()) == sum(
        int(inp.active.sum()) for inp, _ in fits)
    failed1 = []
    for inp, model_name in fits:
        lo, hi, p_seed, pm, u0, s1_budget, _ = tlm._prepare(cfg, inp)
        _, _, conv1, _, _, _ = tlm.lm_solve(
            cfg, get_model(model_name), inp, u0, lo, hi, p_seed, pm,
            inp.active, max(cfg.lm_max_iter_stage1, cfg.lm_stage1_wide),
            cfg.lm_lambda_init, s1_budget)
        failed1.append(int((inp.active & ~conv1).sum()))
    assert all(failed1), "every bucket's stage 1 leaves lanes to retry"
    rungs = counts["fit.rungs"]
    if stage3:
        assert rungs == len(fits) * (1 + len(cfg.lm_stage3_pullbacks))
        assert counts["fit.retry_lanes"] > sum(failed1)
    else:
        assert rungs == len(fits)
        assert counts["fit.retry_lanes"] == sum(failed1)
    sites = _sync_sites(counts)
    # the call's one read of its three buckets' sizes
    assert sites.pop("engine.bucket_sizes") == 1
    assert sites.pop("fit.retry_select") == rungs
    # one test a rung, and one more where the ladder stops before its end
    assert rungs <= sites.pop("fit.ladder_any") <= rungs + len(fits)
    # on the CPU the K3 wrapper runs its plain version, the generic loop
    assert sites.pop("fit.lm_loop_done") > 0
    assert sites == {}


def test_front_select_counts_its_two_syncs():
    """A capped bucket compacts its lanes with _front, which now makes no
    sync: the call's engine syncs are its one read of the bucket sizes,
    and its answer keeps the order the two nonzero calls gave (the capped
    bucket fits its first four lanes in index order)."""
    cfg = NPSConfig(**LADDER, fit_capacity=4)
    calib, batch = _batch(cfg)
    kernels.reset_counts()
    out = pipeline.process_batch(cfg, calib, batch)
    sites = _sync_sites(kernels.counts)
    kernels.reset_counts()
    assert {k: v for k, v in sites.items() if k.startswith("engine.")} == {
        "engine.bucket_sizes": 1}
    fitted = out.fit_n_iter.reshape(-1) > 0
    npulse = out.wfnpulse.reshape(-1)
    small = ((batch.pres & calib["preswf"][None, :]).reshape(-1)
             & out.gate.reshape(-1) & (npulse > 0)
             & (npulse <= cfg.fit_small_pulses))
    assert int(small.sum()) > 4
    assert torch.equal(torch.nonzero(fitted & small).squeeze(1),
                       torch.nonzero(small).squeeze(1)[:4])


def test_counts_report_names_every_counter():
    kernels.reset_counts()
    assert kernels.counts_report().splitlines()[-1] == "program counters: none"
    kernels.count("engine.process_batch")
    kernels.count("fit.retry_lanes", 7)
    assert kernels.counts_report().splitlines()[-1] == (
        "program counters: engine.process_batch 1, fit.retry_lanes 7")
    kernels.reset_counts()
    assert not kernels.counts


@pytest.fixture(scope="module")
def segment():
    cfg = NPSConfig(**GRID, maxwfpulses=2)
    cal = synthetic_calibration(cfg, seed=2)
    truth = make_events(cfg, cal, 13, occupancy=0.15, max_pulses=2,
                        pileup_prob=0.5, seed=5)
    streams, hits = synth_records(cfg, truth, np.random.default_rng(6),
                                  pres=truth.npulse > 0)
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(1, 14, dtype=np.float64),
                        runnum=np.full(13, 3000.0))
    return cfg, cal, seg


def test_run_segment_records_its_waits(segment, tmp_path):
    """One produce_wait a produced group, write_wait on the main thread,
    and the stages the StageTimer always had, under their own names."""
    cfg, cal, seg = segment
    t = StageTimer()
    run_segment(cfg, cal, seg, str(tmp_path / "wf.npz"), batch_size=4,
                timers=t, device="cpu")
    groups = -(-seg.n_events // 4)
    assert t.counts["produce_wait"] == groups
    assert t.counts["write_wait"] >= 1
    assert t.counts["decode"] == t.counts["upload"] == groups
    assert t.counts["pipeline"] == t.counts["fetch"] == groups
    assert t.counts["write"] == groups and t.counts["merge"] == 1


def _all_threads_supported() -> bool:
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return False
    return True


def test_profile_dir_traces_the_stage_workers(segment, tmp_path):
    """run_segment(profile_dir=...) writes a Chrome trace in which the
    decode spans sit on the stage workers, not on the main thread."""
    if not _all_threads_supported():
        pytest.skip("this torch's profiler has no profile_all_threads "
                    "option: only the thread that starts it is recorded")
    cfg, cal, seg = segment
    prof = tmp_path / "prof"
    run_segment(cfg, cal, seg, str(tmp_path / "wf.npz"), batch_size=4,
                device="cpu", profile_dir=str(prof))
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("npswf."):
            tids.setdefault(e["name"], set()).add(e["tid"])
    main = tids["npswf.runtime.produce_wait"]
    assert len(main) == 1
    assert tids["npswf.runtime.decode"] - main
    assert tids["npswf.runtime.write"] - main
    assert "npswf.engine.process_batch" in tids


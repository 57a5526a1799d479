"""The readers of the program's spans and counters, on contexts made up by
hand: the StageTimer samples of a window and the program's counters."""
from types import SimpleNamespace

import pytest

from npswf_tpu_torch import kernels
from wfbench import spec


def _ctx(timers=None, window_s=2.0):
    return SimpleNamespace(timers=timers, window_s=window_s)


@pytest.mark.parametrize("name,stage", [
    ("runtime.produce_wait_pct", "produce_wait"),
    ("runtime.write_wait_pct", "write_wait")])
def test_wait_shares_are_the_stage_over_the_window(name, stage):
    read = spec.load_reader(name)
    # 0.3 s and 0.2 s of waiting in a 2-s window; other stages ignored
    ctx = _ctx({stage: [0.3, 0.2], "merge": [1.0]})
    assert read(ctx) == pytest.approx(25.0)
    # a program without the stage (the parent), or no window: nothing
    assert read(_ctx({"merge": [1.0]})) is None
    assert read(_ctx(None)) is None
    assert read(_ctx({stage: [0.3]}, window_s=0.0)) is None


@pytest.fixture
def counters():
    kernels.reset_counts()
    yield kernels.count
    kernels.reset_counts()


def test_program_syncs_are_the_sites_over_the_calls(counters):
    read = spec.load_reader("engine.program_syncs_per_batch")
    assert read(_ctx()) is None                  # no call counted
    counters("engine.process_batch", 4)
    counters("sync.engine.bucket_size", 12)
    counters("sync.fit.ladder_any", 12)
    counters("sync.fit.retry_select", 12)
    counters("sync.engine.diagnostics_window", 4)
    counters("fit.retry_lanes", 1000)            # not a sync
    assert read(_ctx()) == pytest.approx(10.0)


def test_retry_lanes_are_a_share_of_stage1(counters):
    read = spec.load_reader("fit.retry_lanes_pct")
    assert read(_ctx()) is None                  # nothing fitted
    counters("fit.stage1_lanes", 800)
    assert read(_ctx()) == 0.0                   # no rung ran
    counters("fit.retry_lanes", 12)
    assert read(_ctx()) == pytest.approx(1.5)


def test_counter_readers_read_nothing_from_a_program_without_counters(
        monkeypatch):
    """The parent's kernels module has launches and plain calls only."""
    monkeypatch.delattr(kernels, "counts")
    for name in ("engine.program_syncs_per_batch", "fit.retry_lanes_pct"):
        assert spec.load_reader(name)(_ctx()) is None

"""The profile reduction on events made up by hand."""
import pytest

from wfbench import profile


def test_busy_idle_gaps_and_counts():
    events = [
        # host: the benchmark's span, a torch op inside it, a sync
        (False, "wfbench.slice", 0.0, 100.0, 1),
        (False, "aten::nonzero", 10.0, 40.0, 1),
        (False, "cudaStreamSynchronize", 20.0, 38.0, 1),
        (False, "cudaLaunchKernel", 60.0, 62.0, 1),
        (False, "cudaLaunchKernel", 64.0, 65.0, 1),
        # device: two kernels on one stream, a copy on another, overlapping
        (True, "void npswf::lm_kernel<float, 2>(float const*)", 5.0, 20.0, 7),
        (True, "Memcpy DtoH (Device -> Pinned)", 15.0, 25.0, 8),
        (True, "void npswf::search_kernel<float>(float const*)", 70.0, 90.0, 7),
    ]
    t = profile.reduce_events(events, "wfbench.slice")
    assert t.span == (0.0, 100.0)
    assert t.busy_us == pytest.approx(20.0 + 20.0)       # [5, 25] and [70, 90]
    assert t.syncs() == 1 and t.runtime["cudaLaunchKernel"] == 2
    assert len(t.kernels()) == 2 and len(t.kernels("lm_kernel<")) == 1
    # idle: [0, 5] named by the span, [25, 70] by the op covering 47.5 (none
    # but the span), [90, 100] by the span
    gaps = dict()
    for name, us in t.gaps:
        gaps[name] = gaps.get(name, 0.0) + us
    assert gaps == {"wfbench.slice": 5.0 + 45.0 + 10.0}
    b = profile.breakdown(t)
    assert b["device_ops"][0] == ["void npswf::search_kernel<float>",
                                  pytest.approx(20e-6)]
    assert b["idle_gaps"] == [["wfbench.slice", pytest.approx(60e-6)]]


def test_gaps_take_the_innermost_op_on_any_thread():
    events = [(False, "wfbench.segment_pass", 0.0, 1000.0, 1)]
    # many short ops on the main thread before the gap
    events += [(False, f"aten::op{i}", 2.0 * i, 2.0 * i + 1.0, 1)
               for i in range(1, 400)]
    events += [(False, "aten::copy_", 850.0, 990.0, 2),
               (False, "cudaMemcpyAsync", 900.0, 980.0, 2),
               (True, "k", 0.0, 800.0, 5), (True, "k", 990.0, 1000.0, 5)]
    t = profile.reduce_events(events, "wfbench.segment_pass")
    # the gap [800, 990] has its middle at 895: aten::copy_ on thread 2
    # (shorter than the span that covers it on thread 1)
    assert t.gaps == [("aten::copy_", 190.0)]

"""A whole run on the CPU at a few events, past the look for a card: the
result line's keys, and ``correct`` true on the sound program."""
import pytest

from conftest import run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,trace", [
    ("fp32.batch_dense", False), ("fp32.batch_dense", True),
    ("fp32.segment_sparse", False), ("fp32.segment_sparse", True)])
def test_line_keys_and_a_sound_run(name, trace):
    cell = tiny_cell(name)
    out = run_tiny(cell, trace=trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["card", "checks"]
    assert list(out) == keys            # checks comes last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= cell.traffic.get("events_per_call", 1)
    assert set(out["checks"]) == set(cell.limits)
    want = ({m["name"] for m in cell.per_layer} if trace
            else {m["name"] for m in cell.end_to_end})
    got = set(out["metrics"])
    if trace:
        # the CPU has no device trace: only the host-side readers read
        assert got <= want
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert got == want
        for m in out["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])


def test_the_reference_follows_a_search_capacity():
    """With fewer search lanes than present lanes, the program drops the
    present lanes past its capacity, and the reference, told the same
    capacity, reads those lanes as the program does."""
    import torch
    from wfbench import generate, harness
    from wfbench.spec import Geometry
    cell = tiny_cell("fp32.batch_dense")
    fields = dict(cell.fields, search_capacity=1000)
    data = generate.make_traffic(fields, cell.traffic, 2 ** 31 + 21,
                                 workers=1)
    cpu = torch.device("cpu")
    entry = harness.BatchEntry(fields, data, cpu, cell.dtype_name)
    entry.window(0.0)
    assert entry.failed_lanes() > 0
    numbers, missing = harness.check_batches(
        Geometry(fields), data, entry.answers([0, 1]), cell.dtype_name, cpu)
    assert missing is None
    assert all(v == 0 for v in numbers.values()), numbers

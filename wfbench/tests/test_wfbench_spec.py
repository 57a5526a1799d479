"""The loader finds every cell's files by name and refuses what it cannot
find; BENCHMARK.json keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from wfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_is_found_with_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell.config_name == w["config"]
        assert cell.traffic["entry"] in ("run_segment", "process_batch")
        assert cell.fields["compute_dtype"] in ("float32", "float64")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.limits) >= {"decisions_pct", "time_gap_bins"}
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"]))


@pytest.mark.parametrize("kind,call", [
    ("workload", lambda: spec.cell("fp32.no_such_mix")),
    ("config", lambda: spec.config_fields("no_such_config")),
    ("traffic", lambda: spec.traffic("no_such_mix")),
    ("metric", lambda: spec.load_reader("no.such.metric")),
    ("limits", lambda: spec.limits("fp32.no_such_mix")),
])
def test_unknown_names_are_refused(kind, call):
    with pytest.raises(spec.SpecError):
        call()


def test_benchmark_json_keeps_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["wfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("wfbench/") and os.path.isfile(
            os.path.join(spec.ROOT, c["file"]))
        data = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert data["reduced"] == c["reduced"]
    cells = bench["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"setup_s", "segment_blocks_per_s", "batch_blocks_per_s",
                   "batch_p95_ms"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        layers.add(m["layer"])
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get(
            "workloads", [w["name"] for w in cells]))
    every = (bench["configs"] + cells + bench["end_to_end"]
             + bench["per_layer"])
    assert all(NAME.match(x["name"]) for x in every)
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"]
               + bench["per_layer"])
    for group in (bench["configs"], cells, bench["end_to_end"]
                  + bench["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len(json.dumps(bench)) < 64 * 1024
    # every cell reports setup_s, another end-to-end metric and a layer's
    for w in cells:
        cell = spec.cell(w["name"], bench)
        assert len(cell.end_to_end) >= 2 and cell.per_layer

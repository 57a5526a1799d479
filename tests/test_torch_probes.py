"""The port's four throughput probes, run through its CLI on the CPU at tiny
sizes (a 6 x 5 grid in place of the probes' configuration, a few events,
perf-probe's sweeps cut to two values): each exits 0 and prints its JSON
with the keys its users read.
Their numbers here are host-clock numbers of this machine's CPU and are
not checked.
"""
import json

import pytest

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.tools import cli, perf_probe
import tests.torch_threads  # noqa: F401 (one torch thread a process)

PROBES = {
    "measure-link": (["--cpu", "--n", "2", "--size-mb", "1"],
                     ("device", "h2d", "d2h", "dense_batch")),
    "perf-probe floor": (["floor", "--cpu", "--events", "2", "--iters", "2",
                          "--chain", "1"],
                         ("noop_ms", "pipelined_ms_per_batch",
                          "chain1_ms_per_batch")),
    "perf-probe esweep": (["esweep", "--cpu"],
                          ("E1_ms_per_batch", "E2_ms_per_batch")),
    "perf-probe chain": (["chain", "--cpu", "--events", "1", "--iters", "2"],
                         ("k1_ms_per_batch", "k2_ms_per_batch")),
    "glue-profile": (["--cpu", "--events", "2", "--k1", "1", "--k2", "2",
                      "--iters", "1"],
                     ("full", "fit", "search", "diag", "glue_direct",
                      "fit_stage3", "fit_stage2")),
    "e2e-bench": (["--cpu", "--events", "4", "--batch-size", "2", "--mode",
                   "both", "--chain-batches", "2"], None),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_runs_and_prints_its_json(probe, capsys, tmp_path, monkeypatch):
    monkeypatch.setattr("npswf_tpu_torch.utils.timing.probe_config",
                        lambda: NPSConfig(compute_dtype="float32", nlin=6,
                                          ncol=5))
    monkeypatch.setattr(perf_probe, "ESWEEP_EVENTS", (1, 2))
    monkeypatch.setattr(perf_probe, "CHAIN_KS", (1, 2))
    args, keys = PROBES[probe]
    name = probe.split()[0]
    if name == "e2e-bench":
        args = args + ["--workdir", str(tmp_path)]
    assert cli.main([name, "--", *args]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if name == "e2e-bench":
        assert [r["mode"] for r in res] == ["dense", "sparse"]
        for r in res:
            assert r["e2e_blocks_per_sec"] > 0 and r["device_blocks_per_sec"] > 0
            assert {"decode", "pipeline", "write", "merge"} <= set(
                r["stage_medians_ms"])
        return
    assert set(keys) <= set(res), res
    if name == "measure-link":
        assert res["h2d"]["median_GBps"] > 0
        assert res["dense_batch"]["up_mb"] > 15.2
    else:
        assert all(res[k] == res[k] for k in keys)     # no NaN

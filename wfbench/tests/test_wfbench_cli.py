"""The command line: what the harness loads, how it refuses a machine
without the card, and (on the card) one short run of a cell."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

RUN = os.path.join(ROOT, "wfbench", "run.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "npswf_tpu"}


def _py(code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_the_harness_loads_no_jax_and_no_jax_package():
    """Import every module of the harness, read every cell, run a tiny
    cell's reference and its program on the CPU, then list the top-level
    names of every loaded module, compared whole."""
    code = (
        "import sys, json, time, torch\n"
        "sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "from wfbench import spec, harness, control, generate, compare, "
        "profile, roofline\n"
        "from wfbench.reference import pipeline, segment\n"
        "from conftest import tiny_cell, run_tiny\n"
        "for w in spec.benchmark()['workloads']: spec.cell(w['name'])\n"
        "run_tiny(tiny_cell('fp32.segment_sparse'), trace=True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (ROOT, os.path.join(ROOT, "wfbench", "tests")))
    res = _py(code)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "npswf_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from wfbench import harness
    monkeypatch.setitem(sys.modules, "npswf_tpu_torch_like", sys)
    assert "npswf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "npswf_tpu.core", sys)
    assert harness.forbidden_modules() == ["npswf_tpu"]


def test_help_and_no_card_fail_clearly():
    res = subprocess.run([sys.executable, RUN, "--help"], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "--workload" in res.stdout
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cell in ("fp32.segment_sparse", "fp64.batch_dense"):
        res = subprocess.run([sys.executable, RUN, "--workload", cell,
                              "--seed", str(2 ** 31 + 1), "--seconds", "1",
                              "--trace", "0"], capture_output=True, text=True,
                             timeout=300, env=env, cwd="/")
        assert res.returncode == 2 and res.stdout == ""
        assert "no CUDA device" in res.stderr
    res = subprocess.run([sys.executable, RUN, "--workload", "fp32.nothing",
                          "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and "unknown workload" in res.stderr
    assert res.stdout == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, RUN, "--workload",
                          "fp32.batch_dense", "--seed", str(2 ** 31 + 77),
                          "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["metrics"]["engine.launches_per_batch"]["value"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]

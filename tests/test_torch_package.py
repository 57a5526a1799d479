"""The PyTorch port as a package: no jax, and which path a tensor takes.

This file imports no jax, so its card tests also run on a machine without
it (``python -m pytest --noconftest tests/test_torch_package.py -m cuda``).
Tests marked ``cuda`` need a CUDA device and skip without one.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import process_batch
from npswf_tpu_torch.utils.synthetic import make_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(pathlib.Path(REPO, "npswf_tpu_torch").rglob("*.py")) + [
    pathlib.Path(REPO, "chip_smoke.py")]

# the four routes of process_batch and the kernels each launches
SLICE = dict(use_pallas_lm=False, pallas_search_select=True)
ROUTES = {
    "default": ({}, {kernels.MATCHED_FILTER, kernels.SEARCH_OPERANDS,
                     kernels.LM_SOLVE}),
    "slice": (SLICE, {kernels.MATCHED_FILTER, kernels.SEARCH_TOPK,
                      kernels.FUSED_EVAL}),
    "fused_neq": (dict(SLICE, use_fused_neq=True),
                  {kernels.MATCHED_FILTER, kernels.SEARCH_TOPK,
                   kernels.FUSED_EVAL, kernels.FUSED_NEQ}),
    "fused_system": (dict(SLICE, use_fused_system=True),
                     {kernels.MATCHED_FILTER, kernels.SEARCH_TOPK,
                      kernels.FUSED_SYSTEM}),
}


def _small(**kw):
    cfg = NPSConfig(ncol=5, nlin=6, **kw)
    cal = synthetic_calibration(cfg, seed=2)
    truth = make_events(cfg, cal, 2, occupancy=0.4, max_pulses=3,
                        pileup_prob=0.5, seed=7)
    return cfg, cal, truth


def _foreign(name: str) -> bool:
    """jax, jaxlib or a module of the JAX package (not of the port)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "npswf_tpu")


def test_port_imports_no_jax():
    """Importing every port module and chip_smoke loads no jax and no module
    of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import npswf_tpu_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(npswf_tpu_torch.__path__, "
            "'npswf_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'npswf_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'npswf_tpu_torch.fit.eval_kernel' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_SOURCES])
def test_port_sources_import_no_jax(path):
    """No import statement of the port or of chip_smoke, lazy ones inside
    functions included, names jax or the JAX package."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _foreign(n)], path


@pytest.mark.parametrize("route", list(ROUTES))
def test_cpu_tensors_take_the_plain_path(route):
    """No kernel is launched for CPU tensors; the plain version of each
    kernel of the route runs, and no other."""
    flags, names = ROUTES[route]
    cfg, cal, truth = _small(**flags)
    calib = calib_to_torch(cal.device_arrays(cfg), "cpu", torch.float32)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(2), "cpu",
                           torch.float32)
    kernels.reset_counts()
    out = process_batch(cfg, calib, batch)
    assert sum(kernels.launches.values()) == 0
    assert {n for n, c in kernels.plain_calls.items() if c > 0} == names
    assert int(out.n_fit_success) > 0
    assert out.wftime.dtype == torch.float32


def test_build_needs_the_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_tensors_launch_the_kernels(card, dtype, route):
    """On the card the route's kernels launch and no other, the plain
    versions are not called, and the decisions match the plain path run on
    the card."""
    flags, names = ROUTES[route]
    cfg, cal, truth = _small(**flags)
    calib = calib_to_torch(cal.device_arrays(cfg), card, dtype)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(2), card, dtype)
    kernels.reset_counts()
    out = process_batch(cfg, calib, batch)
    torch.cuda.synchronize()
    assert {n for n, c in kernels.launches.items() if c > 0} == names
    assert sum(kernels.plain_calls.values()) == 0
    ref = process_batch(cfg, calib, batch, plain=True)
    assert torch.equal(out.wfnpulse, ref.wfnpulse)
    assert torch.equal(out.gate, ref.gate)
    if dtype == torch.float64:
        assert torch.equal(out.fit_converged, ref.fit_converged)
        assert torch.equal(out.fit_n_iter, ref.fit_n_iter)


@pytest.mark.cuda
def test_search_kernel_refuses_a_wide_frame(card):
    """sigma = 3 needs Gold taps beyond the kernel frame's 16-row margin."""
    from npswf_tpu_torch.ops.search_kernel import search_operands_kernel
    src = torch.zeros((4, 110), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="lh_gold"):
        search_operands_kernel(NPSConfig(spec_sigma=3.0), src, src, -1)

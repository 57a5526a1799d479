"""The PyTorch port as a package: no jax, and which path a tensor takes.

This file imports no jax, so its card tests also run on a machine without
it (``python -m pytest --noconftest tests/test_torch_package.py -m cuda``).
Tests marked ``cuda`` need a CUDA device and skip without one.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from npswf_tpu.core import NPSConfig, synthetic_calibration
from npswf_tpu.utils.synthetic import make_events
from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import process_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "npswf_tpu_torch", "npswf_tpu_torch.kernels", "npswf_tpu_torch.core.params",
    "npswf_tpu_torch.ops.matched_filter", "npswf_tpu_torch.ops.mf_kernel",
    "npswf_tpu_torch.ops.peak_search", "npswf_tpu_torch.ops.search_kernel",
    "npswf_tpu_torch.ops.cluster_gate", "npswf_tpu_torch.ops.spline",
    "npswf_tpu_torch.models.waveform", "npswf_tpu_torch.fit.errors",
    "npswf_tpu_torch.fit.linalg", "npswf_tpu_torch.fit.lm",
    "npswf_tpu_torch.fit.lm_kernel", "npswf_tpu_torch.engine.diagnostics",
    "npswf_tpu_torch.engine.pipeline",
]


def _small():
    cfg = NPSConfig(ncol=5, nlin=6)
    cal = synthetic_calibration(cfg, seed=2)
    truth = make_events(cfg, cal, 2, occupancy=0.4, max_pulses=3,
                        pileup_prob=0.5, seed=7)
    return cfg, cal, truth


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k.startswith('jaxlib'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cpu_tensors_take_the_plain_path():
    """No kernel is launched for CPU tensors; each plain version runs."""
    cfg, cal, truth = _small()
    calib = calib_to_torch(cal.device_arrays(cfg), "cpu", torch.float32)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(2), "cpu",
                           torch.float32)
    kernels.reset_counts()
    out = process_batch(cfg, calib, batch)
    assert sum(kernels.launches.values()) == 0
    for name in kernels.KERNEL_NAMES:
        assert kernels.plain_calls[name] > 0, name
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_tensors_launch_the_kernels(card, dtype):
    """On the card every kernel launches, the plain versions are not
    called, and the decisions match the plain path run on the card."""
    cfg, cal, truth = _small()
    calib = calib_to_torch(cal.device_arrays(cfg), card, dtype)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(2), card, dtype)
    kernels.reset_counts()
    out = process_batch(cfg, calib, batch)
    torch.cuda.synchronize()
    assert all(kernels.launches[n] > 0 for n in kernels.KERNEL_NAMES)
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

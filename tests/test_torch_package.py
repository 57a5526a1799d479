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
import threading

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
            "for m in ('fit.eval_kernel', 'runtime.executor', 'io.native', "
            "'io.decode', 'tools.cli', 'utils.timers', 'golden.reference', "
            "'parallel.axis', 'parallel.mesh', 'parallel.dryrun', "
            "'tools.e2e_bench', 'tools.glue_profile', 'tools.perf_probe', "
            "'tools.measure_link', 'utils.timing'):\n"
            "    assert 'npswf_tpu_torch.' + m in sys.modules, m\n")
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


def test_counts_exact_from_two_threads():
    """The segment executor runs process_batch on two threads: the plain
    calls of two concurrent runs are counted exactly twice those of one
    (with a short switch interval, so that an unlocked += would lose
    updates)."""
    cfg, cal, truth = _small()
    calib = calib_to_torch(cal.device_arrays(cfg), "cpu", torch.float32)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(2), "cpu",
                           torch.float32)
    kernels.reset_counts()
    process_batch(cfg, calib, batch)
    one = dict(kernels.plain_calls)
    kernels.reset_counts()
    errors = []

    def work():
        try:
            for _ in range(2):
                process_batch(cfg, calib, batch)
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert dict(kernels.plain_calls) == {k: 4 * v for k, v in one.items()}
    assert sum(kernels.launches.values()) == 0


def test_count_increments_lose_nothing():
    """Stress of the counters alone: 16 threads (more than the cores) count
    the same 5,000 new names under a short switch interval (a Counter's
    first increment of a name calls back into Python); every increment
    counts."""
    kernels.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    names = [f"stress{i}" for i in range(5000)]

    def work():
        for name in names:
            kernels.count_plain(name)
            kernels.count_launch(name)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert set(kernels.plain_calls.values()) == {16}
    assert set(kernels.launches.values()) == {16}
    kernels.reset_counts()


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
@pytest.mark.parametrize("n", [1, 33, 257])
@pytest.mark.parametrize("P,max_pulses", [(1, 1), (2, 2), (5, 5), (10, 6),
                                          (12, 6), (13, 13), (14, 7),
                                          (15, 15)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lm_kernel_bit_equal_to_plain(card, dtype, P, max_pulses, n):
    """K3 against its plain version on retry-shaped calls (stage-2 cap,
    mixed budgets with some at 0, some inactive lanes, a partial last
    block): u, chi2, conv, n_iter and lambda equal on every lane. Widths
    above 12 draw their inputs at maxwfpulses = P."""
    from chip_smoke import lm_equal, lm_retry_inputs
    from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel, lm_solve_plain
    cfg = NPSConfig(compute_dtype="float32", maxwfpulses=max(P, 12))
    cal = synthetic_calibration(cfg, seed=1)
    args = lm_retry_inputs(torch, cfg, cal, n, max_pulses, P, 61 + n + P,
                           dtype, card)
    k = lm_solve_kernel(cfg, *args)
    p = lm_solve_plain(cfg, *args)
    torch.cuda.synchronize()
    assert lm_equal(torch, k, p) == n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("P", [16, 24, "limit"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lm_kernel_wide_bit_equal_to_plain(card, dtype, P, n):
    """K3's wide unit (csrc/lm_wide.cu, P at run time) against its plain
    version on retry-shaped calls of up to 8 pulses a lane: u, chi2, conv,
    n_iter and lambda equal on every lane. At the limit (the widest P whose
    lane fits a block, lm_max_pulses) the call's iterations are cut to 4:
    the plain version's substitutions take M^2 launches an iteration."""
    from chip_smoke import lm_equal, lm_retry_inputs
    from npswf_tpu_torch.fit.lm_kernel import (lm_max_pulses, lm_solve_kernel,
                                               lm_solve_plain)
    cfg = NPSConfig(compute_dtype="float32")
    limit = P == "limit"
    P = lm_max_pulses(cfg.nfitbins, dtype) if limit else P
    cfg = cfg.replace(maxwfpulses=P)
    cal = synthetic_calibration(cfg, seed=1)
    args = list(lm_retry_inputs(torch, cfg, cal, n, 8, P, 61 + n + P, dtype,
                                card))
    if limit:
        args[10] = 4
    k = lm_solve_kernel(cfg, *args)
    p = lm_solve_plain(cfg, *args)
    torch.cuda.synchronize()
    assert lm_equal(torch, k, p) == n


def _system_cases(n, P, max_pulses, dtype, dev):
    """K6's and, for P <= NARROW_P, K7's calls on n lanes:
    [(kernel name, kernel call, plain call)]."""
    from chip_smoke import system_inputs
    from npswf_tpu_torch.fit.eval_kernel import (fused_neq, fused_neq_plain,
                                                 fused_system,
                                                 fused_system_plain)
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    sys_args, neq_args = system_inputs(torch, cfg, cal, n, P, max_pulses,
                                       81 + n + P, dtype, dev)
    cases = [("system_kernel", lambda: fused_system(cfg, *sys_args),
              lambda: fused_system_plain(cfg, *sys_args))]
    if neq_args is not None:
        cases.append(("neq_kernel", lambda: fused_neq(cfg, *neq_args),
                      lambda: fused_neq_plain(cfg, *neq_args)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 257])
@pytest.mark.parametrize("P,max_pulses", [(1, 1), (2, 2), (3, 3), (4, 4),
                                          (5, 5), (10, 6), (12, 6)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_system_kernels_bit_equal_to_plain(card, dtype, P, max_pulses, n):
    """K6 (every width here) and K7 (P <= 4) against their plain versions
    on lane counts that leave a ragged last tile: A, g and chi2 equal, value
    for value."""
    from chip_smoke import n_unequal
    for _, run_k, run_p in _system_cases(n, P, max_pulses, dtype, card):
        k, p = run_k(), run_p()
        torch.cuda.synchronize()
        assert [n_unequal(torch, x, y) for x, y in zip(k, p)] == [0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("P,max_pulses", [(2, 2), (12, 6)])
def test_system_kernels_launch_once(card, P, max_pulses):
    """A K6 or K7 call on the card is one device activity, its kernel: no
    transpose, no unpack gather, no copy of the inputs."""
    from chip_smoke import device_activities
    for name, run_k, _ in _system_cases(257, P, max_pulses, torch.float32,
                                        card):
        run_k()
        acts = device_activities(torch, run_k)
        assert len(acts) == 1 and name in acts[0], acts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_refuse_widths_they_do_not_take(card, dtype):
    """K3 takes a width while one lane's arrays fit a block (lm_max_pulses:
    71 in fp64 and 106 in fp32 at K = 90 on an H100) and K6 while one
    lane's tile fits (61 at K = 90): wider calls raise before any launch."""
    from npswf_tpu_torch.fit.eval_kernel import SEG, fused_system
    from npswf_tpu_torch.fit.lm_kernel import lm_max_pulses, lm_solve_kernel
    cfg = NPSConfig()
    N, K = 2, cfg.nfitbins
    limit = lm_max_pulses(K, dtype)
    assert limit >= 61

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=card)
    for P, run in ((limit + 1, "lm"), (62, "system")):
        M = 1 + 2 * P
        mask = torch.ones((N, M), dtype=torch.bool, device=card)
        args = (z(N, 4, SEG), z(N), z(N, K), z(N, K), z(N, M), z(N, M),
                z(N, M), z(N, M), mask)
        kernels.reset_counts()
        with pytest.raises(ValueError, match=(f"1..{limit} pulses"
                                              if run == "lm" else "tile")):
            if run == "lm":
                lm_solve_kernel(cfg, *args, mask[:, 0], 10, 1e-3)
            else:
                fused_system(cfg, *args)
        assert not kernels.launches


def test_fp32_division_through_fp64_reciprocal():
    """K1 divides fp32 a by fp32 b as fp32(a * (1.0 / fp64(b)))
    (csrc/matched_filter.cu, fp32_div): bit-equal to IEEE fp32 a / b
    wherever that fp64 quotient is zero or at least 2^-126 in size, on
    random bit patterns (zeros, denormals, infinities and NaNs among them)
    and on integer-like values of mixed scale."""
    rng = np.random.default_rng(0)
    n = 1 << 20

    def bits():
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32).view(np.float32)

    def scaled():
        return (rng.integers(-(1 << 24), 1 << 24, n)
                * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    for a, b in ((bits(), bits()), (scaled(), scaled()), (scaled(), bits()),
                 (bits(), scaled())):
        with np.errstate(all="ignore"):
            ref = a / b
            q = a.astype(np.float64) * (1.0 / b.astype(np.float64))
            got = q.astype(np.float32)
        tiny = (np.abs(q) < 2.0 ** -126) & (q != 0)
        same = (got.view(np.uint32) == ref.view(np.uint32)) | (
            np.isnan(got) & np.isnan(ref))
        assert (~tiny).sum() > n // 2
        assert same[~tiny].all()


def _mf_lanes(n, dev):
    """The matched filter's inputs for the first n lanes of bench-like
    events (fp64), and the calibration's config."""
    from chip_smoke import mf_lanes
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, -(-n // cfg.nblocks), occupancy=1.0,
                        max_pulses=2, pileup_prob=0.25, seed=7)
    return cfg, [a[:n].contiguous() for a in mf_lanes(torch, cal, truth.signal, dev)]


# 70 and 257 lanes are not a multiple of any kernel's tile (8, 16 lanes)
LANE_COUNTS = [1, 33, 70, 257]


@pytest.mark.cuda
@pytest.mark.parametrize("n", LANE_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_matched_filter_kernel_bit_equal_to_plain(card, dtype, n):
    """K1 against its plain version: every value equal."""
    from chip_smoke import n_unequal
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.ops.mf_kernel import matched_filter_kernel
    cfg, lanes = _mf_lanes(n, card)
    args = [a.to(dtype) for a in lanes]
    k = matched_filter_kernel(cfg, *args)
    p = matched_filter(cfg, *args)
    torch.cuda.synchronize()
    assert n_unequal(torch, k, p) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", LANE_COUNTS)
@pytest.mark.parametrize("mode", ["operands", "select1", "select12"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_search_kernel_bit_equal_to_plain(card, dtype, mode, n):
    """K2 (operands) and K4 (select, P = 1 and 12) against their plain
    versions: all four outputs equal on every bin or slot, a NaN matching a
    NaN."""
    from chip_smoke import n_unequal
    from npswf_tpu_torch.ops.matched_filter import matched_filter
    from npswf_tpu_torch.ops.peak_search import search_operands, search_topk
    from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                                   search_topk_kernel)
    cfg, lanes = _mf_lanes(n, card)
    src = matched_filter(cfg, *lanes).to(torch.float32).to(dtype)
    aux = lanes[0].to(dtype)
    if mode == "operands":
        p = search_operands(cfg, src, aux, -1)
        k = search_operands_kernel(cfg, src, aux, -1)
    else:
        P = int(mode[len("select"):])
        p = search_topk(cfg, src, aux, -1, P)
        k = search_topk_kernel(cfg, src, aux, -1, P)
    torch.cuda.synchronize()
    assert [n_unequal(torch, x, y) for x, y in zip(k, p)] == [0] * 4


@pytest.mark.cuda
def test_search_kernel_refuses_a_wide_frame(card):
    """sigma = 3 needs Gold taps beyond the kernel frame's 16-row margin."""
    from npswf_tpu_torch.ops.search_kernel import search_operands_kernel
    src = torch.zeros((4, 110), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="lh_gold"):
        search_operands_kernel(NPSConfig(spec_sigma=3.0), src, src, -1)

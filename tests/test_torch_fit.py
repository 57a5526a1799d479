"""The PyTorch port's LM fit against the JAX package, on the CPU (fp64).

The port's K3 wrapper on CPU tensors runs its plain version (the generic LM
iteration on the padded segment planes). The JAX side runs its whole-loop
Pallas kernel in interpret mode and its XLA while-loop. Tolerances are
those of tests/test_pallas_lm.py, which holds the JAX kernel against the
JAX while-loop: per-lane decisions exact, values to summation-order
rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.fit.errors import error_model as jax_error_model
from npswf_tpu.fit.linalg import cholesky_solve as jax_cholesky_solve
from npswf_tpu.fit.lm import _prepare as jax_prepare
from npswf_tpu.fit.lm import fit_waveforms as jax_fit_waveforms
from npswf_tpu.fit.lm import lm_solve as jax_lm_solve
from npswf_tpu.fit.pallas_eval import pad_coeffs as jax_pad_coeffs
from npswf_tpu.fit.pallas_lm import lm_solve_pallas
from npswf_tpu.models.waveform import get_model as jax_get_model
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.fit import lm as tlm
from npswf_tpu_torch.fit.errors import error_model
from npswf_tpu_torch.fit.eval_kernel import pad_coeffs
from npswf_tpu_torch.fit.linalg import cholesky_solve
from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel
from npswf_tpu_torch.models.waveform import get_model
from tests.test_fit import _build_inputs
from tests.test_pallas_lm import _assert_match, _narrow
import tests.torch_threads  # noqa: F401 (one torch thread a process)


def _t(a):
    return torch.as_tensor(np.array(a))


def _port(cfg):
    """The port's own config with the JAX config's values."""
    return TorchConfig.from_json(cfg.to_json())


def _to_torch(inp):
    return tlm.FitInputs(*(None if v is None else _t(v) for v in inp))


def _solve_ours(cfg, inp, max_iter, lam0, iter_budget=None):
    lo, hi, p_seed, pm, u0, _, _ = jax_prepare(cfg, inp)
    out = lm_solve_kernel(
        _port(cfg), pad_coeffs(_t(inp.coeffs)), _t(inp.x0), _t(inp.y),
        1.0 / _t(inp.sigma), _t(u0), _t(lo), _t(hi), _t(p_seed), _t(pm),
        _t(inp.active), max_iter, lam0,
        None if iter_budget is None else _t(iter_budget))
    return tuple(o.numpy() for o in out)


@pytest.mark.parametrize("P", [2, 12])
def test_lm_solve_matches_jax_kernel_and_while_loop(cfg, cal, P):
    """A full-budget stage on a mixed ensemble (inactive lanes included):
    conv and n_iter exact, u/chi2/lam/edm at the JAX kernel-vs-loop
    tolerances, against lm_solve_pallas (interpret) and the XLA lm_solve."""
    if P == 2:
        inp, *_ = _build_inputs(cfg, cal, n_lanes=48, seed=11, max_pulses=2,
                                seed_jitter=2.0)
        inp = _narrow(inp)
        act = np.ones(48, bool)
        act[5] = act[17] = False
        inp = inp._replace(active=jnp.asarray(act))
        max_iter = 12
    else:
        inp, *_ = _build_inputs(cfg, cal, n_lanes=24, seed=21, max_pulses=6,
                                seed_jitter=1.5, noise=0.8)
        max_iter = 14
    ours = _solve_ours(cfg, inp, max_iter, cfg.lm_lambda_init)
    lo, hi, p_seed, pm, u0, _, _ = jax_prepare(cfg, inp)
    ker = lm_solve_pallas(cfg, jax_pad_coeffs(inp.coeffs), inp.x0, inp.y,
                          1.0 / inp.sigma, u0, lo, hi, p_seed, pm, inp.active,
                          max_iter, cfg.lm_lambda_init, interpret=True)
    xla = jax_lm_solve(cfg.replace(use_pallas=False), jax_get_model("spline_ref"),
                       inp, u0, lo, hi, p_seed, pm, inp.active, max_iter,
                       cfg.lm_lambda_init)
    assert ours[2].sum() > 0.5 * np.asarray(inp.active).sum()
    _assert_match(ours, ker)
    _assert_match(ours, xla)


def test_lm_solve_budgets_and_lambda_array(cfg, cal):
    """Per-lane budgets (zero included) freeze the same lanes at the same
    points; a per-lane lam0 is honoured."""
    rng = np.random.default_rng(5)
    inp, *_ = _build_inputs(cfg, cal, n_lanes=32, seed=12, max_pulses=2,
                            seed_jitter=2.5)
    inp = _narrow(inp)
    budget = jnp.asarray(rng.integers(0, 9, 32), jnp.int32)
    lam0 = jnp.asarray(10.0 ** rng.uniform(-4, -1, 32))
    ours = _solve_ours(cfg, inp, 8, _t(lam0), budget)
    lo, hi, p_seed, pm, u0, _, _ = jax_prepare(cfg, inp)
    xla = jax_lm_solve(cfg.replace(use_pallas=False), jax_get_model("spline_ref"),
                       inp, u0, lo, hi, p_seed, pm, inp.active, 8, lam0, budget)
    _assert_match(ours, xla)
    z = np.asarray(budget) == 0
    assert not ours[2][z].any()
    np.testing.assert_array_equal(ours[3][z], 0)


@pytest.mark.parametrize("model_name", ["spline_ref", "spline_ref_pallas"])
def test_fit_waveforms_full_ladder_matches(cfg, cal, model_name):
    """The whole ladder (stage 1, stage-2 seed restart, stage-3 pull-back
    rungs) decision for decision against the JAX XLA ladder, through the
    port's kernel route (spline_ref_pallas) and its generic model route."""
    inp, *_ = _build_inputs(cfg, cal, n_lanes=40, seed=13, max_pulses=2,
                            seed_jitter=3.5, noise=1.0)
    inp = _narrow(inp)
    ref = jax_fit_waveforms(cfg.replace(use_pallas=False, lm_stage1_tier=0),
                            inp, "spline_ref")
    ours = tlm.fit_waveforms(_port(cfg), _to_torch(inp), model_name)
    assert not np.asarray(ref.converged_stage1).all()   # stage 2+ exercised
    for f in ("converged", "converged_stage1", "n_iter"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    c = np.asarray(ref.converged)
    np.testing.assert_allclose(ours.params.numpy()[c], np.asarray(ref.params)[c],
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(ours.chi2_ndf.numpy()[c],
                               np.asarray(ref.chi2_ndf)[c], rtol=1e-8)
    # failed lanes report their seeds on both sides
    np.testing.assert_allclose(ours.params.numpy()[~c], np.asarray(ref.params)[~c],
                               rtol=1e-12, atol=1e-12)


def test_fit_waveforms_plain_flag_matches_kernel_route(cfg, cal):
    """plain=True (generic loop) and the K3 wrapper's CPU route agree."""
    inp, *_ = _build_inputs(cfg, cal, n_lanes=16, seed=14, max_pulses=2)
    inp = _to_torch(_narrow(inp))
    a = tlm.fit_waveforms(_port(cfg), inp, "spline_ref_pallas")
    b = tlm.fit_waveforms(_port(cfg), inp, "spline_ref_pallas", plain=True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_error_model_and_cholesky_match_jax(cfg):
    rng = np.random.default_rng(3)
    y = rng.normal(0, 30, (8, 110))
    # XLA may turn the divide by err_scale into a multiply: last-ulp only
    np.testing.assert_allclose(error_model(_port(cfg), torch.as_tensor(y)).numpy(),
                               np.asarray(jax_error_model(cfg, jnp.asarray(y))),
                               rtol=4e-16, atol=0)
    X = rng.normal(size=(6, 9, 9))
    A = X @ X.transpose(0, 2, 1) + 9 * np.eye(9)
    b = rng.normal(size=(6, 9))
    ours = cholesky_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_cholesky_solve(
        jnp.asarray(A), jnp.asarray(b))), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", A, ours), b, atol=1e-10)


def _nan_max(v, lo):
    """torch.clamp(v, min=lo): NaN passes through."""
    return v if np.isnan(v) else max(v, lo)


def _sqrt(v):
    """torch's square root of one value, as the plain version takes it of
    a one-lane batch (on the CPU it may differ from numpy's in the last
    bit; on the card both sides round it exactly)."""
    return torch.sqrt(torch.as_tensor(np.array([v]))).numpy()[0]


def _wide_schedule_solve(A, b, eps):
    """A x = b for one SPD system in csrc/lm_wide.cu's schedule, one value
    and one rounding at a time (A, b numpy of the working type): row 0 of
    the factor divided by its d at once; then at step s every trailing
    entry (a, c), a > s, of the upper triangle takes its one subtraction
    L(s, a) L(s, c), and row s + 1 is divided by its d; the forward solve
    one column behind (row i subtracts L(s - 1, i) y(s - 1) at step s);
    the back solve with the products L(q, k) x(k) formed once x(k) is
    known, row r subtracting them in ascending k after its first term,
    L(r, r + 1) x(r + 1), which it forms itself."""
    ft = A.dtype.type
    M = A.shape[0]
    eps = ft(eps)
    S = {(a, c): A[a, c] for a in range(M) for c in range(a, M)}
    dg = [None] * M
    d0 = _sqrt(_nan_max(S[0, 0], eps))
    for c in range(M):
        if c == 0:
            dg[0] = S[0, 0] / d0
        else:
            S[0, c] = S[0, c] / d0
    for s in range(M - 1):
        # every trailing entry once, last row first: the order within a
        # step is free, the subtractions of one entry run in s
        for a in range(M - 1, s, -1):
            la = S[s, a]
            d = _sqrt(_nan_max(S[a, a] - la * la, eps)) if a == s + 1 else None
            for c in range(M - 1, a - 1, -1):
                x = S[a, c] - la * S[s, c]
                if d is None:
                    S[a, c] = x
                elif c == a:
                    dg[a] = x / d
                else:
                    S[a, c] = x / d
    acc = list(b)
    y = [None] * M
    for s in range(M):
        for i in range(s, M):
            if s > 0:
                acc[i] = acc[i] - S[s - 1, i] * y[s - 1]
        y[s] = acc[s] / dg[s]
    x = [None] * M
    prod = {}
    for r in range(M - 1, -1, -1):
        a = y[r]
        if r + 1 < M:
            a = a - S[r, r + 1] * x[r + 1]
        for k in range(r + 2, M):
            a = a - prod[r, k]
        x[r] = a / dg[r]
        for q in range(r - 1):
            prod[q, r] = S[q, r] * x[r]
    return np.array(x, dtype=ft)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("M", [33, 49])
def test_cholesky_solve_runs_in_the_wide_kernels_order(M, dtype):
    """fit/linalg.py::cholesky_solve, the plain version of K3's solve,
    equals csrc/lm_wide.cu's schedule bit for bit on seeded damped,
    Jacobi-scaled SPD systems: the right-looking factor entry by entry, the
    forward solve column by column, the back solve with its products formed
    first and subtracted in ascending k. The card's kernel is bit-equal to
    the plain version only while the plain version keeps this order."""
    rng = np.random.default_rng(M)
    for lam in (1e-3, 1.0, 30.0):
        X = rng.normal(size=(M, M + 7))
        A = X @ X.T
        sc = np.sqrt(np.diag(A))
        As = (A / (sc[:, None] * sc[None, :])).astype(dtype)
        As = np.triu(As) + np.triu(As, 1).T            # exactly symmetric
        np.fill_diagonal(As, dtype(1) + dtype(lam))
        b = rng.normal(size=M).astype(dtype)
        ours = _wide_schedule_solve(As, b, 1e-30)
        ref = cholesky_solve(torch.as_tensor(As[None]), torch.as_tensor(b[None]),
                             1e-30)[0].numpy()
        assert ref.dtype == ours.dtype
        np.testing.assert_array_equal(ref.view(np.uint8), ours.view(np.uint8))


def test_unported_models_raise():
    """Every model family of the JAX package is registered in the port
    (gaussian and biexp included), each under its own name; a name that is
    no model still raises."""
    for name in ("spline_ref", "spline_ref_pallas", "gaussian", "biexp"):
        assert get_model(name).name == jax_get_model(name).name == name
    with pytest.raises(KeyError):
        get_model("no_such_model")

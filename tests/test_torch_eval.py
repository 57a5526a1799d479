"""The port's K4-K7 and its generic LM loop against the JAX package (CPU).

Same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas.py and
tests/test_pallas_search.py do; the port's wrappers, given CPU tensors,
run their plain versions. All at fp64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.fit.lm import _dp_du as jax_dp_du
from npswf_tpu.fit.lm import _prepare as jax_prepare
from npswf_tpu.fit.lm import _to_physical as jax_to_physical
from npswf_tpu.fit.lm import fit_waveforms as jax_fit_waveforms
from npswf_tpu.fit.pallas_eval import fused_eval as jax_fused_eval
from npswf_tpu.fit.pallas_eval import fused_neq as jax_fused_neq
from npswf_tpu.fit.pallas_eval import fused_system as jax_fused_system
from npswf_tpu.fit.pallas_eval import pad_coeffs as jax_pad_coeffs
from npswf_tpu.ops.pallas_search import search_topk_pallas
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.fit import lm as tlm
from npswf_tpu_torch.fit.eval_kernel import (PAD, fused_eval, fused_neq,
                                             fused_system, pad_coeffs)
from npswf_tpu_torch.ops.peak_search import search_operands
from npswf_tpu_torch.ops.search_kernel import search_topk_kernel
from tests.test_fit import _build_inputs
from tests.test_pallas_lm import _narrow
from tests.test_torch_ops import _lanes, _mf32

SLICE = dict(use_pallas_lm=False, pallas_search_select=True)
ROUTES = {"slice": SLICE,
          "fused_neq": dict(SLICE, use_fused_neq=True),
          "fused_system": dict(SLICE, use_fused_system=True)}


def _port(cfg):
    """The port's own config with the JAX config's values."""
    return TorchConfig.from_json(cfg.to_json())


def _t(a):
    return torch.as_tensor(np.array(a))


def _system_inputs(cfg, cal, P, seed=9):
    """One LM point per lane: inputs of tests/test_pallas.py::
    test_pallas_fused_system_matches_generic, u perturbed by +-0.3."""
    inp, *_ = _build_inputs(cfg, cal, n_lanes=24, seed=seed,
                            max_pulses=min(P, 6), seed_jitter=3.0)
    inp = _narrow(inp, P)
    lo, hi, p_seed, pm, u0, _, _ = jax_prepare(cfg, inp)
    u = u0 + jnp.asarray(np.random.default_rng(3).uniform(-0.3, 0.3, u0.shape))
    return inp, u, lo, hi, p_seed, pm


def _assert_system_close(ours, ref):
    """The tolerances of tests/test_pallas.py:136-143."""
    A, g, chi2 = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(ours[0].numpy(), A,
                               atol=1e-9 * (np.abs(A).max() + 1.0), rtol=0)
    np.testing.assert_allclose(ours[1].numpy(), g,
                               atol=1e-9 * (np.abs(g).max() + 1.0), rtol=0)
    np.testing.assert_allclose(ours[2].numpy(), chi2, rtol=1e-10)
    np.testing.assert_array_equal(ours[0].numpy(),
                                  ours[0].numpy().transpose(0, 2, 1))


@pytest.mark.parametrize("P", [2, 12])
def test_fused_eval_matches_jax(cfg, cal, P):
    """f, Jt and Ja to 1e-12 relative, with times drawn over the whole
    reachable range, the segment-slot wrap at t + x0 > fit_lo_bin + PAD - 1
    included (tests/test_pallas.py:54-57)."""
    rng = np.random.default_rng(P)
    N = 96
    blocks = rng.integers(0, cfg.nblocks, N)
    t = rng.uniform(-60, 95, (N, P))
    a = rng.uniform(10, 200, (N, P))
    ped = rng.uniform(-5, 5, N)
    pm = rng.random((N, P)) < 0.8
    coeffs, x0 = cal.spline_coeffs[blocks], cal.spline_x0[blocks]
    assert (t + x0[:, None] > cfg.fit_lo_bin + PAD - 1).any()
    ref = jax_fused_eval(cfg, jax_pad_coeffs(jnp.asarray(coeffs)),
                         jnp.asarray(x0), jnp.asarray(t), jnp.asarray(a),
                         jnp.asarray(ped), jnp.asarray(pm), interpret=True)
    ours = fused_eval(_port(cfg), pad_coeffs(_t(coeffs)), _t(x0), _t(t), _t(a),
                      _t(ped), _t(pm))
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12, atol=0)
    assert (ours[2].numpy() != 0).any()


@pytest.mark.parametrize("P", [2, 4, 12])
def test_fused_system_matches_jax(cfg, cal, P):
    inp, u, lo, hi, p_seed, pm = _system_inputs(cfg, cal, P)
    w = 1.0 / inp.sigma
    ref = jax_fused_system(cfg, jax_pad_coeffs(inp.coeffs), inp.x0, inp.y, w,
                           u, lo, hi, p_seed, pm, interpret=True)
    ours = fused_system(_port(cfg), pad_coeffs(_t(inp.coeffs)), _t(inp.x0),
                        _t(inp.y), _t(w), _t(u), _t(lo), _t(hi), _t(p_seed),
                        _t(pm))
    _assert_system_close(ours, ref)


@pytest.mark.parametrize("P", [2, 4])
def test_fused_neq_matches_jax(cfg, cal, P):
    """K7 on K5's outputs, each package on its own K5."""
    inp, u, lo, hi, p_seed, pm = _system_inputs(cfg, cal, P, seed=10)
    w = 1.0 / inp.sigma
    p = jax_to_physical(u, lo, hi, p_seed, pm)
    dd = jax_dp_du(u, lo, hi, pm)
    ev = jax_fused_eval(cfg, jax_pad_coeffs(inp.coeffs), inp.x0, p[:, 1::2],
                        p[:, 2::2], p[:, 0], inp.pulse_mask, interpret=True)
    ref = jax_fused_neq(cfg, inp.y, w, *ev, dd, interpret=True)
    tc = _port(cfg)
    tp = _t(p)
    f, jt, ja = fused_eval(tc, pad_coeffs(_t(inp.coeffs)), _t(inp.x0),
                           tp[:, 1::2], tp[:, 2::2], tp[:, 0],
                           _t(inp.pulse_mask))
    ours = fused_neq(tc, _t(inp.y), _t(w), f, jt, ja, _t(dd))
    _assert_system_close(ours, ref)


def _tie_lanes(T):
    """Spectra with two and with three equal peaks: the top-P order must
    take equal keys in bin order."""
    x = np.arange(T, dtype=np.float64)
    bump = lambda c: 80.0 * np.exp(-0.5 * ((x - c) / 2.0) ** 2)  # noqa: E731
    return np.stack([bump(30) + bump(60), bump(25) + bump(50) + bump(80),
                     bump(70) + bump(40)])


@pytest.mark.parametrize("P", [3, 12])
def test_search_topk_matches_jax_and_the_sort(cfg, cal, P):
    """The top-P slots against the Pallas select-mode kernel (interpret
    mode) and against the port's own sort route: valid slots and negkey
    exact, centroid, pos_y and aux to 1e-12 relative; lanes with more than
    P peaks and with equal peaks included."""
    sig, mins, kern, mfint = _lanes(cfg, cal, occupancy=0.6, max_pulses=4,
                                    pileup_prob=0.8, seed=17)
    mf = np.concatenate([_mf32(cfg, sig, mins, kern, mfint),
                         _tie_lanes(cfg.ntime)])
    aux = np.concatenate([sig, _tie_lanes(cfg.ntime)[:, ::-1]])
    tc = _port(cfg)
    ours = [o.numpy() for o in search_topk_kernel(tc, _t(mf), _t(aux), -1, P)]
    ref = [np.asarray(r) for r in search_topk_pallas(
        cfg, jnp.asarray(mf), jnp.asarray(aux), -1, P, interpret=True)]
    ops = search_operands(tc, _t(mf), _t(aux), -1)
    order = torch.sort(ops[0], dim=1, stable=True).indices[:, :P]
    srt = [torch.gather(o, 1, order).numpy() for o in ops]
    valid = np.isfinite(ref[0])
    assert (valid.sum(axis=1) == P).any() and (~valid).any()
    assert valid[-3:].sum() == 7                     # the tie lanes
    for other in (ref, srt):
        np.testing.assert_array_equal(np.isfinite(other[0]), valid)
        np.testing.assert_array_equal(ours[0][valid], other[0][valid])
        for o, r in zip(ours[1:], other[1:]):
            np.testing.assert_allclose(o[valid], r[valid], rtol=1e-12, atol=0)
    assert (ours[0][~valid] == np.inf).all()


@pytest.mark.parametrize("route", list(ROUTES))
def test_fit_waveforms_routes_match_jax(cfg, cal, route):
    """The generic LM loop through each system evaluation, against the same
    configuration in interpret mode (tests/test_pallas.py:146-163):
    converged and n_iter exact, params to 1e-10."""
    inp, *_ = _build_inputs(cfg, cal, n_lanes=24, seed=9, max_pulses=2,
                            seed_jitter=2.5)
    inp = _narrow(inp)
    flags = ROUTES[route]
    ref = jax_fit_waveforms(cfg.replace(interpret_pallas=True, **flags), inp,
                            "spline_ref_pallas")
    ours = tlm.fit_waveforms(
        _port(cfg).replace(**flags),
        tlm.FitInputs(*(None if v is None else _t(v) for v in inp)),
        "spline_ref_pallas")
    for f in ("converged", "n_iter"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert ours.converged.numpy().sum() >= 12
    np.testing.assert_allclose(ours.params.numpy(), np.asarray(ref.params),
                               rtol=1e-10, atol=1e-10)

"""The port's plain versions against the JAX package at the first setting
past each width or search setting the card once refused, on the CPU at
fp64.

On the card K3 takes at most 77 pulses in fp64 (112 in fp32) at K = 90 fit
bins, as a lane's arrays must fit a block's shared memory (the JAX
package's Pallas LM stops at 61). K6 took at most 61 and K2/K4 at most 127
Gold taps past the first (spec_sigma 19.06) and frames that eight lanes fit
a block's shared memory; those two now take one lane a block, or fewer
lanes a block, past those limits and are held bit-equal to their plain
versions on the card (tests/test_torch_package.py, chip_smoke.py). Here the
plain versions (the wrappers on CPU tensors) meet the JAX package on a few
lanes of seeded inputs made with numpy:

- K6 at P = 62 against the JAX package's XLA system (``eval_and_jac``,
  then the normal equations as ``einsum``s): its Pallas ``fused_system``
  in interpret mode takes ~10 minutes at this width;
- the LM stage at P = 78 against the JAX package's XLA ``lm_solve``, run
  eagerly (``jax.disable_jit``: its compile at M = 157 takes two
  minutes): its Pallas ``lm_solve_pallas`` packs u and five scalars in 128
  output rows, so it takes M + 5 <= 128 (P <= 61) and raises at this
  width, as the port's K3 does past 77;
- K2 and K4 at sigma 19.5 (lh_gold - 1 = 130) and at sigma 27 with the
  widest window (487 = size_ext - 1) against the JAX Pallas search in
  interpret mode, and at sigma 60, where the left extension's fit (2 sigma
  bins) passes the 110 that exist and the JAX kernel sums those that do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.fit.lm import _dp_du as jax_dp_du
from npswf_tpu.fit.lm import _prepare as jax_prepare
from npswf_tpu.fit.lm import _to_physical as jax_to_physical
from npswf_tpu.fit.lm import lm_solve as jax_lm_solve
from npswf_tpu.models.waveform import get_model as jax_get_model
from npswf_tpu.ops.pallas_search import (search_operands_pallas,
                                         search_topk_pallas)
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.fit.eval_kernel import fused_system, pad_coeffs
from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel
from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                               search_topk_kernel)
from tests.test_fit import _build_inputs
from tests.test_pallas_lm import _assert_match
from tests.test_torch_ops import _lanes, _mf32
import tests.torch_threads  # noqa: F401 (one torch thread a process)


def _port(cfg):
    """The port's own config with the JAX config's values."""
    return TorchConfig.from_json(cfg.to_json())


def _t(a):
    return torch.as_tensor(np.array(a))


def test_fused_system_past_the_card_width_matches_jax(cfg, cal):
    """K6 at P = 62 (one owner block a thread past the 512 threads of a
    tile: the card's first refused width) on 4 lanes: A, g and chi2 to
    1e-12 of each lane's largest value, A symmetric."""
    P = 62
    cfg = cfg.replace(maxwfpulses=P)
    inp, *_ = _build_inputs(cfg, cal, n_lanes=4, seed=9, max_pulses=6,
                            seed_jitter=3.0)
    lo, hi, p_seed, pm, u0, _, _ = jax_prepare(cfg, inp)
    u = u0 + jnp.asarray(np.random.default_rng(3).uniform(-0.3, 0.3, u0.shape))
    w = 1.0 / inp.sigma
    p = jax_to_physical(u, lo, hi, p_seed, pm)
    xgrid = jnp.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=inp.y.dtype)
    aux = {"coeffs": inp.coeffs, "x0": inp.x0, "timeref": inp.timeref}
    f, Jp = jax_get_model("spline_ref").eval_and_jac(cfg, p, aux, xgrid,
                                                     inp.pulse_mask)
    r = (inp.y - f) * w
    Ju = Jp * jax_dp_du(u, lo, hi, pm)[:, None, :] * w[:, :, None]
    ref = (np.asarray(jnp.einsum("nki,nkj->nij", Ju, Ju)),
           np.asarray(jnp.einsum("nki,nk->ni", Ju, r)),
           np.asarray(jnp.sum(r * r, axis=1)))
    ours = [o.numpy() for o in fused_system(
        _port(cfg), pad_coeffs(_t(inp.coeffs)), _t(inp.x0), _t(inp.y), _t(w),
        _t(u), _t(lo), _t(hi), _t(p_seed), _t(pm))]
    assert ours[0].shape == (4, 2 * P + 1, 2 * P + 1)
    for o, x in zip(ours, ref):
        scale = np.abs(x).reshape(len(x), -1).max(axis=1)
        scale = scale.reshape((-1,) + (1,) * (x.ndim - 1))
        assert np.all(np.abs(o - x) <= 1e-12 * scale)
    np.testing.assert_array_equal(ours[0], ours[0].transpose(0, 2, 1))


def test_lm_stage_past_the_card_width_matches_jax(cfg, cal):
    """The LM stage at P = 78 (K3's first refused width in fp64) on
    3 lanes of up to 6 pulses, 4 iterations, lambda0 per lane: u, chi2,
    conv, n_iter and lambda at tests/test_pallas_lm.py's tolerances, every
    decision exact."""
    P = 78
    cfg = cfg.replace(maxwfpulses=P)
    inp, *_ = _build_inputs(cfg, cal, n_lanes=3, seed=21, max_pulses=6,
                            seed_jitter=1.5, noise=0.8)
    lam0 = jnp.asarray([1e-3, 1e-2, 1e-1])
    lo, hi, p_seed, pm, u0, _, _ = jax_prepare(cfg, inp)
    with jax.disable_jit():
        ref = jax_lm_solve(cfg.replace(use_pallas=False),
                           jax_get_model("spline_ref"), inp, u0, lo, hi,
                           p_seed, pm, inp.active, 4, lam0)
    ours = lm_solve_kernel(
        _port(cfg), pad_coeffs(_t(inp.coeffs)), _t(inp.x0), _t(inp.y),
        1.0 / _t(inp.sigma), _t(u0), _t(lo), _t(hi), _t(p_seed), _t(pm),
        _t(inp.active), 4, _t(lam0))
    ours = tuple(o.numpy() for o in ours)
    assert ours[0].shape == (3, 2 * P + 1)
    assert np.all(ours[3] >= 1)
    _assert_match(ours, ref)


@pytest.fixture(scope="module")
def lanes(cfg, cal):
    """8 lanes with pileup: the fp32-quantized filter output and the raw
    signal, fp64."""
    sig, mins, kern, mfint = _lanes(cfg, cal, n=8, occupancy=0.9,
                                    max_pulses=3, pileup_prob=0.5)
    return _mf32(cfg, sig, mins, kern, mfint), sig


# (sigma, window): lh_gold - 1 = 130, past the 127 the launch's parameters
# held; sigma 27 at its widest window; sigma 60, whose extension fit of
# 2 sigma bins passes the 110 that exist
PAST = [(19.5, 3), (27.0, 487), (60.0, 3)]
IDS = [f"sigma{s}-window{w}" for s, w in PAST]


@pytest.mark.parametrize("sigma,window", PAST, ids=IDS)
def test_search_operands_past_the_card_reach_matches_jax(cfg, lanes, sigma,
                                                         window):
    """K2's plain version against search_operands_pallas (interpret):
    negkey, pos_y and aux bit-equal on every bin, the centroid to 1e-12
    (tests/test_torch_search_wide.py's rule)."""
    mf, sig = lanes
    c = cfg.replace(spec_sigma=sigma, spec_aver_window=window)
    ours = [o.numpy() for o in search_operands_kernel(
        _port(c), torch.as_tensor(mf), torch.as_tensor(sig), -1)]
    ref = [np.asarray(r).T for r in search_operands_pallas(
        c, jnp.asarray(mf), jnp.asarray(sig), -1, interpret=True)]
    assert np.isfinite(ref[0]).sum() >= 4
    for i in (0, 2, 3):
        np.testing.assert_array_equal(ours[i], ref[i])
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("sigma,window", PAST, ids=IDS)
def test_search_topk_past_the_card_reach_matches_jax(cfg, lanes, sigma,
                                                     window):
    """K4's plain version against search_topk_pallas (interpret) at P = 4:
    negkey and pos_y bit-equal on every slot, aux bit-equal and the
    centroid to 1e-12 on the valid slots."""
    mf, sig = lanes
    c = cfg.replace(spec_sigma=sigma, spec_aver_window=window)
    ours = [o.numpy() for o in search_topk_kernel(
        _port(c), torch.as_tensor(mf), torch.as_tensor(sig), -1, 4)]
    ref = [np.asarray(r) for r in search_topk_pallas(
        c, jnp.asarray(mf), jnp.asarray(sig), -1, 4, interpret=True)]
    valid = np.isfinite(ref[0])
    assert valid.sum() >= 4
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[3][valid], ref[3][valid])
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=1e-12,
                               atol=0)

"""K2 and K4 at wide search settings against the JAX package, on the CPU.

TSpectrum's sigma sets the Gold response's reach, lh_gold - 1 (13 at the
default sigma = 2, 20 at sigma = 3, 67 at sigma = 10), and the Markov
window its neighbours; the kernels' frame margins hold both
(csrc/search.cu). Here the wrappers run their plain versions (CPU
tensors) against the JAX package's Pallas search kernel in interpret mode,
at fp64 on 64 lanes of one synthetic event (T = 110). negkey, pos_y and
the aux samples are bit-equal on every bin; the centroid agrees to 1e-12
relative (the Pallas kernel's prefix sum is a log-tree, the port's runs
in bin order). The whole batch runs at the reference's sigma = 3
production fixture setting through both packages' process_batch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.golden.reference import tspectrum_search_golden
from npswf_tpu.ops.pallas_search import (search_operands_pallas,
                                         search_topk_pallas)
from npswf_tpu_torch.ops.peak_search import search_geometry, tspectrum_search
from npswf_tpu_torch.ops.search_kernel import (search_operands_kernel,
                                               search_topk_kernel)
from tests.test_torch_ops import _lanes, _mf32, _port
from tests.test_torch_pipeline import _assert_fp64_match, _run_both
import tests.torch_threads  # noqa: F401 (one torch thread a process)

# (spec_sigma, spec_aver_window): Gold reaches 17, 20, 26 and 67, and
# windows 17, 24 and 40, each past the 16-row margin of the default frame
WIDE = [(2.6, 3), (3.0, 3), (4.0, 3), (10.0, 3), (2.0, 17), (2.0, 24),
        (3.0, 40)]
IDS = [f"sigma{s}-window{w}" for s, w in WIDE]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's outputs by (config, dtype, seed), once a module."""
    return {}


@pytest.fixture(scope="module")
def lanes(cfg, cal):
    """64 lanes with pileup: the fp32-quantized filter output and the raw
    signal, fp64."""
    sig, mins, kern, mfint = _lanes(cfg, cal, occupancy=0.6, max_pulses=3,
                                    pileup_prob=0.5)
    return _mf32(cfg, sig, mins, kern, mfint), sig


def _wide(cfg, sigma, window):
    return cfg.replace(spec_sigma=sigma, spec_aver_window=window)


@pytest.mark.parametrize("sigma,window", WIDE, ids=IDS)
def test_search_operands_wide_matches_jax_kernel(cfg, lanes, sigma, window):
    """K2's wrapper (its plain version here) against search_operands_pallas:
    negkey, pos_y and aux bit-equal on every bin, the centroid to 1e-12."""
    mf, sig = lanes
    c = _wide(cfg, sigma, window)
    ours = [o.numpy() for o in search_operands_kernel(
        _port(c), torch.as_tensor(mf), torch.as_tensor(sig), -1)]
    ref = [np.asarray(r).T for r in search_operands_pallas(
        c, jnp.asarray(mf), jnp.asarray(sig), -1, interpret=True)]
    assert np.isfinite(ref[0]).sum() > 20
    for i in (0, 2, 3):
        np.testing.assert_array_equal(ours[i], ref[i])
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("sigma,window", WIDE, ids=IDS)
def test_search_topk_wide_matches_jax_kernel(cfg, lanes, sigma, window):
    """K4's wrapper (its plain version here) against search_topk_pallas at
    P = 4: negkey and pos_y bit-equal on every slot, aux bit-equal and the
    centroid to 1e-12 on the valid slots (the Pallas kernel writes zeros
    past a lane's peaks, the sort the rejected bins' values; the caller
    masks them)."""
    mf, sig = lanes
    c = _wide(cfg, sigma, window)
    ours = [o.numpy() for o in search_topk_kernel(
        _port(c), torch.as_tensor(mf), torch.as_tensor(sig), -1, 4)]
    ref = [np.asarray(r) for r in search_topk_pallas(
        c, jnp.asarray(mf), jnp.asarray(sig), -1, 4, interpret=True)]
    valid = np.isfinite(ref[0])
    assert valid.sum() > 20
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[3][valid], ref[3][valid])
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=1e-12,
                               atol=0)


def test_search_window_past_the_frame_matches_golden(cfg, cal):
    """A Markov window past the extended frame (size_ext - 1 = 137 bins at
    sigma = 2): every neighbour beyond an edge is the edge value, as in
    TSpectrum (the JAX package's XLA slices stop at the frame's width), so
    positions equal the golden reference's on clean spectra."""
    sig, mins, kern, mfint = _lanes(cfg, cal, n=24, occupancy=0.25,
                                    max_pulses=3, seed=11)
    mf = _mf32(cfg, sig, mins, kern, mfint)
    window = search_geometry(_port(cfg), cfg.ntime)[1] + 12
    c = cfg.replace(spec_aver_window=window)
    px, py, valid = (o.numpy() for o in tspectrum_search(
        _port(c), torch.as_tensor(mf)))
    checked = 0
    for lane in range(mf.shape[0]):
        gx, gy = tspectrum_search_golden(
            mf[lane], sigma=c.spec_sigma, threshold_frac=c.specthres,
            max_peaks=c.maxwfpulses, aver_window=window)
        n = int(valid[lane].sum())
        assert n == len(gx), f"lane {lane}: {n} vs {len(gx)}"
        np.testing.assert_array_equal(px[lane, :n], gx)
        np.testing.assert_allclose(py[lane, :n], gy, rtol=1e-12)
        checked += n
    assert checked > 10


def test_process_batch_wide_search_matches_jax_fp64(jax_refs, small_cfg,
                                                    small_cal):
    """The prod_sigma3_threshold5 fixture's setting (sigma = 3, threshold
    5%) through both packages' process_batch on the default route: every
    decision and counter exact, every float to 1e-9 relative."""
    cfg = small_cfg.replace(spec_sigma=3.0, specthres=0.05)
    ours, ref = _run_both(jax_refs, cfg, small_cal, torch.float64)
    assert ours["gate"].sum() > 20
    assert ours["fit_converged"].sum() >= 20
    _assert_fp64_match(ours, ref)

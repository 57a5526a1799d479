"""The PyTorch port's ops against the JAX package, on the CPU.

Both packages get the same numpy inputs. The port runs its plain versions
(CPU tensors); the JAX side runs as its own tests run it: the XLA paths,
and the Pallas kernels in interpret mode.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.ops.cluster_gate import cluster_gate as jax_cluster_gate
from npswf_tpu.ops.matched_filter import matched_filter as jax_matched_filter
from npswf_tpu.ops.pallas_kernels import matched_filter_pallas
from npswf_tpu.ops.pallas_search import search_operands_pallas
from npswf_tpu.ops.peak_search import find_pulses as jax_find_pulses
from npswf_tpu.ops.peak_search import tspectrum_search as jax_tspectrum_search
from npswf_tpu.ops.spline import spline_eval_grad as jax_spline_eval_grad
from npswf_tpu.utils.synthetic import make_events
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.ops.cluster_gate import cluster_gate
from npswf_tpu_torch.ops.mf_kernel import matched_filter_kernel
from npswf_tpu_torch.ops.peak_search import (find_pulses, search_operands,
                                             tspectrum_search)
from npswf_tpu_torch.ops.search_kernel import search_operands_kernel
from npswf_tpu_torch.ops.spline import spline_eval_grad
from tests.test_fixtures import FIXTURE_PATH

with open(FIXTURE_PATH) as _f:
    _FIXTURES = json.load(_f)["fixtures"]

def _port(cfg):
    """The port's own config with the JAX config's values."""
    return TorchConfig.from_json(cfg.to_json())


DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def _lanes(cfg, cal, n=64, seed=3, occupancy=0.5, max_pulses=3, **kw):
    """n lanes of one synthetic event: signal, baseline, kernel, mfint."""
    truth = make_events(cfg, cal, 1, occupancy=occupancy, seed=seed,
                        max_pulses=max_pulses, **kw)
    sig = truth.signal.reshape(-1, cfg.ntime)[:n]
    return (sig, sig.min(axis=1), cal.mfkern_rev[:n], cal.mfint[:n])


def _mf32(cfg, sig, mins, kern, mfint):
    """The matched-filter output quantized to float32, as find_pulses
    searches it."""
    mf = np.asarray(jax_matched_filter(
        cfg, jnp.asarray(sig[:, None, :]), jnp.asarray(mins[:, None]),
        jnp.asarray(kern[:, None, :]), jnp.asarray(mfint[:, None])))[:, 0]
    return mf.astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_matched_filter_bitwise(cfg, cal, dt):
    """Per-tap (delta*kern)/mfint in the JAX order: bit-equal to both the
    XLA op and the Pallas kernel (interpret mode)."""
    npt, tt = DTYPES[dt]
    sig, mins, kern, mfint = (a.astype(npt) for a in _lanes(cfg, cal))
    ours = matched_filter_kernel(_port(cfg), torch.as_tensor(sig), torch.as_tensor(mins),
                                 torch.as_tensor(kern), torch.as_tensor(mfint))
    assert ours.dtype == tt
    xla = np.asarray(jax_matched_filter(
        cfg, jnp.asarray(sig[:, None, :]), jnp.asarray(mins[:, None]),
        jnp.asarray(kern[:, None, :]), jnp.asarray(mfint[:, None])))[:, 0]
    pallas = np.asarray(matched_filter_pallas(
        cfg, jnp.asarray(sig), jnp.asarray(mins), jnp.asarray(kern),
        jnp.asarray(mfint), interpret=True))
    np.testing.assert_array_equal(ours.numpy(), xla)
    np.testing.assert_array_equal(ours.numpy(), pallas)


def test_search_operands_match_pallas_kernel(cfg, cal):
    """The four sort operands against the Pallas search kernel (interpret
    mode, fp64): the accepted bins exactly, values to 1e-12 relative (the
    Pallas kernel's prefix sum is a log-tree, this one is sequential)."""
    sig, mins, kern, mfint = _lanes(cfg, cal, occupancy=0.6, max_pulses=3,
                                    pileup_prob=0.5)
    mf = _mf32(cfg, sig, mins, kern, mfint)
    ours = search_operands_kernel(_port(cfg), torch.as_tensor(mf),
                                  torch.as_tensor(sig), -1)
    ref = search_operands_pallas(cfg, jnp.asarray(mf), jnp.asarray(sig), -1,
                                 interpret=True)
    ours = [o.numpy() for o in ours]
    ref = [np.asarray(r).T for r in ref]           # the kernel returns [T, N]
    acc = np.isfinite(ref[0])
    assert acc.sum() > 20
    np.testing.assert_array_equal(np.isfinite(ours[0]), acc)
    np.testing.assert_array_equal(ours[0][acc], ref[0][acc])
    for o, r in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(o[acc], r[acc], rtol=1e-12, atol=0)


def test_tspectrum_search_matches_jax(cfg, cal):
    """Positions, order and validity exact; pos_y to 1e-12 (XLA path)."""
    sig, mins, kern, mfint = _lanes(cfg, cal, occupancy=0.6, max_pulses=3,
                                    seed=11)
    mf = _mf32(cfg, sig, mins, kern, mfint)
    px, py, valid = (o.numpy() for o in tspectrum_search(_port(cfg),
                                                         torch.as_tensor(mf)))
    jx, jy, jv = (np.asarray(o) for o in jax_tspectrum_search(cfg, jnp.asarray(mf)))
    assert jv.sum() > 20
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_allclose(py, jy, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fx", _FIXTURES, ids=[f["name"] for f in _FIXTURES])
def test_tspectrum_search_decimal_fixture(fx, cfg):
    """The 60-digit-Decimal SearchHighRes fixtures, reproduced exactly."""
    c = cfg.replace(spec_sigma=fx["sigma"], specthres=fx["threshold_frac"],
                    maxwfpulses=fx["max_peaks"],
                    spec_decon_iterations=fx["decon_iterations"],
                    spec_aver_window=fx["aver_window"])
    src = torch.as_tensor(np.asarray(fx["source"], np.float64))[None, :]
    px, py, valid = tspectrum_search(_port(c), src)
    v = valid[0].numpy()
    assert list(px[0].numpy()[v]) == fx["expected_pos_x"], fx["note"]
    assert list(py[0].numpy()[v]) == fx["expected_pos_y"], fx["note"]


def test_find_pulses_matches_jax(cfg, cal):
    """npulse, slot validity and times exact; amplitudes to 1e-12; both the
    XLA path and the Pallas kernels (interpret mode) on the JAX side."""
    sig, mins, kern, mfint = _lanes(cfg, cal, occupancy=0.6, max_pulses=4,
                                    seed=21, pileup_prob=0.6)
    present = np.ones(sig.shape[0], bool)
    present[::7] = False
    ours = find_pulses(_port(cfg), *(torch.as_tensor(a) for a in
                              (sig, mins, kern, mfint, present)))
    assert int(ours.npulse.sum()) > 20
    for c in (cfg, cfg.replace(interpret_pallas=True)):
        ref = jax_find_pulses(c, *(jnp.asarray(a) for a in
                                   (sig, mins, kern, mfint, present)))
        np.testing.assert_array_equal(ours.npulse.numpy(), np.asarray(ref.npulse))
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(ours.times.numpy(), np.asarray(ref.times))
        np.testing.assert_allclose(ours.amps.numpy(), np.asarray(ref.amps),
                                   rtol=1e-12, atol=0)
        np.testing.assert_array_equal(ours.mf.numpy(), np.asarray(ref.mf))


def test_plain_search_flag_matches_wrapper(cfg, cal):
    """plain=True and the wrapper's CPU dispatch run the same code."""
    sig, mins, kern, mfint = _lanes(cfg, cal, n=32, seed=5)
    mf = torch.as_tensor(_mf32(cfg, sig, mins, kern, mfint))
    a = search_operands(_port(cfg), mf, torch.as_tensor(sig), -1)
    b = search_operands_kernel(_port(cfg), mf, torch.as_tensor(sig), -1)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cluster_gate_exact(small_cfg, small_cal):
    truth = make_events(small_cfg, small_cal, 3, occupancy=0.3, seed=5)
    ours = cluster_gate(_port(small_cfg), torch.as_tensor(truth.signal),
                        torch.as_tensor(small_cal.timeref),
                        small_cal.timerefacc).numpy()
    ref = np.asarray(jax_cluster_gate(small_cfg, jnp.asarray(truth.signal),
                                      jnp.asarray(small_cal.timeref),
                                      small_cal.timerefacc))
    assert 0 < ours.sum() < ours.size
    np.testing.assert_array_equal(ours, ref)


def test_cluster_gate_single_device_only(small_cfg, small_cal, tmp_path):
    """Row shards need their block group: block_shards=2 without one, or
    with an axis name (the JAX package's form), raises; with a group (here
    a world of one, one shard) the gate equals the single device's."""
    from npswf_tpu_torch.parallel.mesh import world_of_one
    truth = make_events(small_cfg, small_cal, 2, occupancy=0.3, seed=5)
    sig = torch.as_tensor(truth.signal)
    args = (_port(small_cfg), sig, torch.as_tensor(small_cal.timeref),
            small_cal.timerefacc)
    for axis in (None, "block"):
        with pytest.raises(TypeError, match="block_axis"):
            cluster_gate(*args, block_axis=axis, block_shards=2)
    with world_of_one(workdir=str(tmp_path)) as rm:
        grouped = cluster_gate(*args, block_axis=rm.block, block_shards=1)
    assert torch.equal(grouped, cluster_gate(*args))


def test_spline_eval_grad_matches_jax(cfg, cal):
    b = np.arange(4) * 97
    t = np.linspace(-5.0, 115.0, 241)[None, :].repeat(4, 0)
    ours = spline_eval_grad(_port(cfg), torch.as_tensor(cal.spline_coeffs[b]),
                            torch.as_tensor(cal.spline_x0[b]), torch.as_tensor(t))
    ref = jax_spline_eval_grad(cfg.replace(spline_mode="gather"),
                               jnp.asarray(cal.spline_coeffs[b]),
                               jnp.asarray(cal.spline_x0[b]), jnp.asarray(t))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))

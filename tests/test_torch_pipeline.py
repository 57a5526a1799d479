"""The PyTorch port's process_batch against the JAX package, on the CPU.

One small batch (6x5 grid, E=4, occupancy 0.4, up to 4 pulses with heavy
pileup) goes through both packages from the same numpy arrays; the JAX side
runs its XLA paths. The bucket bounds are set to 1 and 2 pulses so that
all three fit buckets (M = 3, 5, 25) carry lanes.

Seed note: on some seeds the JAX package's own layouts disagree with each
other on a lane at fp64 (its XLA reduction trees differ with the system
width, see tests/test_routing.py); seed 5 is one where they agree, so exact
agreement is a property of the port and not of the seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.engine.pipeline import EventBatch as JaxEventBatch
from npswf_tpu.engine.pipeline import process_batch as jax_process_batch
from npswf_tpu.utils.synthetic import make_events
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import process_batch

E = 4
EXACT = ("wfnpulse", "pulse_valid", "gate", "fit_converged", "fit_n_iter",
         "h_mask", "search_overflow", "n_fit_success", "n_fit_failure",
         "n_fit_dropped", "n_high_pulse", "n_search_dropped")


_JAX_REFS = {}


def _run_both(cfg, cal, dtype, seed=5, **port_flags):
    """The batch through the JAX package under ``cfg`` (its XLA route, one
    compile per config and dtype) and through the port under ``cfg`` with
    ``port_flags``."""
    npt = np.float64 if dtype == torch.float64 else np.float32
    truth = make_events(cfg, cal, E, occupancy=0.4, max_pulses=4,
                        pileup_prob=0.9, seed=seed)
    sig = truth.signal.astype(npt)
    corr = np.random.default_rng(11).uniform(-2, 2, E).astype(npt)
    arrays = cal.device_arrays(cfg.replace(compute_dtype=np.dtype(npt).name))
    key = (cfg, dtype, seed)
    if key not in _JAX_REFS:
        jcal = {k: jnp.asarray(v) for k, v in arrays.items()}
        jb = JaxEventBatch(signal=jnp.asarray(sig),
                           pres=jnp.asarray(truth.pres.astype(bool)),
                           corr_time_HMS=jnp.asarray(corr), evt=jnp.arange(E),
                           runnum=jnp.zeros(E, jnp.int32))
        ref = jax.jit(lambda b: jax_process_batch(cfg, jcal, b))(jb)
        _JAX_REFS[key] = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    ours = process_batch(TorchConfig.from_json(cfg.to_json()).replace(**port_flags),
                         calib_to_torch(arrays, "cpu", dtype),
                         batch_to_torch(sig, truth.pres, corr, "cpu", dtype))
    ours = {f: getattr(ours, f).numpy() for f in ours._fields}
    return ours, _JAX_REFS[key]


@pytest.fixture(scope="module")
def cfg3(small_cfg):
    return small_cfg.replace(fit_small_pulses=1, fit_mid_pulses=2)


def _assert_fp64_match(ours, ref):
    for f in ref:
        if f in EXACT:
            np.testing.assert_array_equal(ours[f], ref[f], err_msg=f)
        else:
            np.testing.assert_allclose(ours[f], ref[f], rtol=1e-9, atol=1e-9,
                                       err_msg=f)


def test_process_batch_matches_jax_fp64(cfg3, small_cal):
    """Every decision and counter exact; every float to 1e-9 relative."""
    ours, ref = _run_both(cfg3, small_cal, torch.float64)
    n = ours["wfnpulse"][ours["gate"]]
    assert (n == 1).any() and (n == 2).any() and (n >= 3).any()   # 3 buckets
    assert ours["fit_converged"].sum() >= 30
    _assert_fp64_match(ours, ref)


# bucket bounds that send lanes to widths outside the defaults' 2, 4 and 12:
# (config changes, the bucket widths, the pulse counts each bucket takes)
BUCKET_WIDTHS = {
    "mid5": (dict(fit_small_pulses=1, fit_mid_pulses=5), ((1, 1, 1), (5, 2, 5))),
    "wide10": (dict(fit_small_pulses=2, fit_mid_pulses=2, maxwfpulses=10),
               ((2, 1, 2), (10, 3, 10))),
    # K3 up to its widest instantiation: the wide bucket at P = 15 on the
    # default route (pallas_lm_max_pulses raised with it)
    "wide15": (dict(fit_small_pulses=2, fit_mid_pulses=2, maxwfpulses=15,
                    pallas_lm_max_pulses=15), ((2, 1, 2), (15, 3, 15))),
    # above the compiled widths: K3's wide unit (P at run time) at P = 20
    "wide20": (dict(fit_small_pulses=2, fit_mid_pulses=2, maxwfpulses=20,
                    pallas_lm_max_pulses=20), ((2, 1, 2), (20, 3, 20))),
}


@pytest.mark.parametrize("case", list(BUCKET_WIDTHS))
def test_process_batch_bucket_widths_match_jax_fp64(small_cfg, small_cal, case):
    """Buckets of width 5, 10, 15 and 20 (a middle bound of 5; the wide
    bucket at maxwfpulses=10, and at 15 and 20 with pallas_lm_max_pulses
    raised with it: K3's widest compiled width, and its wide unit) carry
    lanes, and the default route matches the JAX package: decisions and
    counters exact, floats to 1e-9 relative."""
    changes, buckets = BUCKET_WIDTHS[case]
    ours, ref = _run_both(small_cfg.replace(**changes), small_cal, torch.float64)
    n = ours["wfnpulse"][ours["gate"]]
    for width, lo, hi in buckets:
        assert ((n >= lo) & (n <= hi)).any(), f"bucket of width {width} empty"
    assert ours["fit_converged"].sum() >= 30
    _assert_fp64_match(ours, ref)


SLICE = dict(use_pallas_lm=False, pallas_search_select=True)


@pytest.mark.parametrize("flags", [SLICE, dict(SLICE, use_fused_neq=True),
                                   dict(SLICE, use_fused_system=True)],
                         ids=["slice", "fused_neq", "fused_system"])
def test_process_batch_routes_match_jax_fp64(cfg3, small_cal, flags):
    """The port's generic LM loop (K5 + batched normal equations, K5 + K7,
    K6) and its in-kernel top-P search (K4), all as plain versions here,
    against the JAX package's XLA route: decisions and counters exact,
    floats to 1e-9 relative."""
    ours, ref = _run_both(cfg3, small_cal, torch.float64, **flags)
    assert ours["fit_converged"].sum() >= 30
    _assert_fp64_match(ours, ref)


def test_process_batch_matches_jax_fp32(cfg3, small_cal):
    """fp32, flip-aware two-tier check (after tests/test_routing.py).

    The search and the gate are exact. In the fit, fp32 summation order
    (einsum here, XLA's reduction trees there) decides marginal ftol/gtol
    tests, so a lane may end a step earlier or later ("trajectory flip",
    seen as a different fit_n_iter). Same-trajectory lanes must agree to
    fp32 rounding; convergence decisions may flip on at most max(4, 2%)
    of the lanes; flipped lanes that converged on both sides must agree
    to the 0.05-bin fp32 parity bar (tests/test_fit.py::
    test_fp32_matches_fp64) at the 90% quantile."""
    ours, ref = _run_both(cfg3, small_cal, torch.float32)
    for f in ("wfnpulse", "pulse_valid", "gate", "search_overflow"):
        np.testing.assert_array_equal(ours[f], ref[f], err_msg=f)
    conv_o, conv_r = ours["fit_converged"], ref["fit_converged"]
    n_conv = int(conv_r.sum())
    assert n_conv >= 30
    assert int((conv_o != conv_r).sum()) <= max(4, int(0.02 * n_conv))
    same = (ours["fit_n_iter"] == ref["fit_n_iter"]) & (conv_o == conv_r)
    for name, atol in (("chi2", 1e-3), ("wftime", 1e-3), ("wfampl", 1e-3),
                       ("pedwf", 1e-3)):
        a, b = ours[name], ref[name]
        m = same[..., None] if a.ndim == 3 else same
        np.testing.assert_allclose(np.where(m, a, 0), np.where(m, b, 0),
                                   rtol=1e-4, atol=atol, err_msg=name)
    both = (conv_o & conv_r)[..., None] & ours["pulse_valid"]
    dt_bins = np.abs(ours["wftime"] - ref["wftime"])[both] / cfg3.dt
    assert np.quantile(dt_bins, 0.9) < 0.05


def test_process_batch_capacities_match_jax(small_cfg, small_cal):
    """search_capacity and fit_capacity below the lane count: the
    compacted search, the compacted narrow bucket, the overflow flags and
    the drop counters, exact at fp64."""
    cfg = small_cfg.replace(search_capacity=100, fit_capacity=24)
    ours, ref = _run_both(cfg, small_cal, torch.float64)
    assert ours["n_search_dropped"] > 0 and ours["n_fit_dropped"] > 0
    _assert_fp64_match(ours, ref)


def test_process_batch_single_device_only(small_cfg, small_cal, tmp_path):
    """Sharded arguments need their groups: axis names (the JAX package's
    form) or block shards without a block group raise; with the groups of
    a world of one the output equals the single device's, field for
    field."""
    from npswf_tpu_torch.parallel.mesh import world_of_one
    cfg64 = small_cfg.replace(compute_dtype="float64")
    truth = make_events(cfg64, small_cal, 2, occupancy=0.4, max_pulses=2,
                        seed=5)
    batch = batch_to_torch(truth.signal, truth.pres, np.zeros(2), "cpu",
                           torch.float64)
    calib = calib_to_torch(small_cal.device_arrays(cfg64), "cpu",
                           torch.float64)
    port = TorchConfig.from_json(cfg64.to_json())
    for kw in ({"block_axis": "block"}, {"reduce_axes": ("data",)},
               {"block_shards": 2}):
        with pytest.raises(TypeError, match="Axis"):
            process_batch(port, calib, batch, **kw)
    ref = process_batch(port, calib, batch)
    with world_of_one(workdir=str(tmp_path)) as rm:
        out = process_batch(port, calib, batch, block_axis=rm.block,
                            reduce_axes=(rm.world,))
    for name, a, b in zip(ref._fields, out, ref):
        assert torch.equal(a, b), name
"""The port's gaussian and biexp model families against the JAX package, on
the CPU.

Both families are plain PyTorch in the port, as they are plain jnp in the
JAX package, and the generic LM loop fits them. Their evaluation and
Jacobian match the JAX models at fp64 to 1e-12 relative; ``process_batch``
under ``model_name``/``model_aux`` matches the JAX pipeline at fp64 on
batches whose true pulses have the family's shape (decisions exact,
values to 1e-9 relative). The rest are the port's analogues of
tests/test_models.py: truth recovery, the better chi2 of the matching
family, the ``model_aux`` JSON round trip and the CLI's ``--model``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.engine.pipeline import EventBatch as JaxEventBatch
from npswf_tpu.engine.pipeline import process_batch as jax_process_batch
from npswf_tpu.models.waveform import get_model as jax_get_model
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import process_batch
from npswf_tpu_torch.models.waveform import get_model
from tests.test_models import _biexp_shape
import tests.torch_threads  # noqa: F401 (one torch thread a process)

AUX = {"gaussian": (("width", 3.5),),
       "biexp": (("tau_r", 1.8), ("tau_d", 9.0))}
EXACT = ("wfnpulse", "pulse_valid", "gate", "fit_converged", "fit_n_iter",
         "h_mask", "n_fit_success", "n_fit_failure")


def _port(cfg):
    return TorchConfig.from_json(cfg.to_json())


def _shape(family, x, c):
    """The family's unit-peak pulse centred (peak) at c."""
    if family == "gaussian":
        return np.exp(-0.5 * ((x - c) / AUX["gaussian"][0][1]) ** 2)
    return _biexp_shape(x, c, AUX["biexp"][0][1], AUX["biexp"][1][1])


def _truth_batch(cfg, cal, family, seed, E=2):
    """Events whose true pulses have the family's shape, six blocks an
    event (tests/test_models.py's batches): signal [E, B, T] and
    (event, block) -> (delta, amp, ped)."""
    rng = np.random.default_rng(seed)
    B, T = cfg.nblocks, cfg.ntime
    x = np.arange(T, dtype=np.float64)
    sig = 0.3 * rng.standard_normal((E, B, T))
    truth = {}
    for e in range(E):
        for b in rng.choice(B, size=6, replace=False):
            delta = rng.uniform(-2.0, 2.0)
            amp = rng.uniform(80.0, 150.0)
            ped = rng.uniform(-3.0, 3.0)
            sig[e, b] += ped + amp * _shape(family, x, cal.timeref[b] + delta)
            truth[(e, int(b))] = (delta, amp, ped)
    return sig, truth


def _port_batch(cfg, cal, sig, dtype=torch.float64):
    E, B, _ = sig.shape
    return (calib_to_torch(cal.device_arrays(cfg), "cpu", dtype),
            batch_to_torch(sig, np.ones((E, B), bool), np.zeros(E), "cpu",
                           dtype))


def _fit_port(cfg, cal, sig):
    calib, batch = _port_batch(cfg, cal, sig)
    out = process_batch(_port(cfg), calib, batch)
    return {f: getattr(out, f).numpy() for f in out._fields}


@pytest.mark.parametrize("with_timeref", [True, False],
                         ids=["timeref", "absolute"])
@pytest.mark.parametrize("family", list(AUX))
def test_eval_and_jac_matches_jax(cfg, family, with_timeref):
    """f [N, K] and J [N, K, M] at fp64 on random parameters, pulse masks
    and block reference times (or none: absolute times), to 1e-12
    relative; ``plain`` changes nothing."""
    rng = np.random.default_rng(17)
    N, P = 9, 4
    params = np.empty((N, 1 + 2 * P))
    params[:, 0] = rng.uniform(-3, 3, N)
    params[:, 1::2] = rng.uniform(-6, 6, (N, P)) + (0.0 if with_timeref
                                                    else 45.0)
    params[:, 2::2] = rng.uniform(20, 150, (N, P))
    mask = rng.random((N, P)) < 0.7
    aux = {k: rng.uniform(0.8, 1.2, N) * v for k, v in AUX[family]}
    if with_timeref:
        aux["timeref"] = rng.uniform(35, 55, N)
    x = np.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=np.float64)
    fj, Jj = jax_get_model(family).eval_and_jac(
        cfg, jnp.asarray(params), {k: jnp.asarray(v) for k, v in aux.items()},
        jnp.asarray(x), jnp.asarray(mask))
    taux = {k: torch.as_tensor(v) for k, v in aux.items()}
    args = (_port(cfg), torch.as_tensor(params), taux, torch.as_tensor(x),
            torch.as_tensor(mask))
    f, J = get_model(family).eval_and_jac(*args)
    assert f.shape == (N, x.size) and J.shape == (N, x.size, 1 + 2 * P)
    # 1e-12 relative, and 1e-12 of the largest value where a sum cancels
    # to near zero (a pedestal against a pulse's tail)
    for ours, ref in ((f, fj), (J, Jj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    fp, Jp = get_model(family).eval_and_jac(*args, plain=True)
    assert torch.equal(fp, f) and torch.equal(Jp, J)


@pytest.mark.parametrize("family", list(AUX))
def test_process_batch_matches_jax_fp64(small_cfg, small_cal, family):
    """process_batch with the family through model_name/model_aux: the
    decisions exact, times, amplitudes, chi2 and pedestals to 1e-9
    relative, against the JAX pipeline on the same batch."""
    cfg = small_cfg.replace(model_name=family, model_aux=AUX[family])
    sig, _ = _truth_batch(small_cfg, small_cal, family, seed=3, E=3)
    E = sig.shape[0]
    jcal = {k: jnp.asarray(v) for k, v in small_cal.device_arrays(cfg).items()}
    jb = JaxEventBatch(signal=jnp.asarray(sig), pres=jnp.ones(sig.shape[:2], bool),
                       corr_time_HMS=jnp.zeros(E), evt=jnp.arange(E),
                       runnum=jnp.zeros(E, jnp.int32))
    ref = jax.jit(lambda b: jax_process_batch(cfg, jcal, b))(jb)
    ours = _fit_port(cfg, small_cal, sig)
    assert ours["fit_converged"].sum() >= 12
    for f in EXACT:
        np.testing.assert_array_equal(ours[f], np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("wftime", "wfampl", "chi2", "pedwf", "timewf", "amplwf"):
        np.testing.assert_allclose(ours[f], np.asarray(getattr(ref, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("family", list(AUX))
def test_family_recovers_truth_through_engine(small_cfg, small_cal, family):
    """The analogue of tests/test_models.py's engine tests: every gated
    truth lane converges, its first pulse time (ns) lies within 0.5 dt of
    truth, its pedestal within 1 count and its amplitude within 15%."""
    cfg = small_cfg.replace(model_name=family, model_aux=AUX[family])
    sig, truth = _truth_batch(small_cfg, small_cal, family,
                              seed=3 if family == "gaussian" else 7)
    out = _fit_port(cfg, small_cal, sig)
    checked = 0
    for (e, b), (delta, amp, ped) in truth.items():
        if not out["gate"][e, b]:
            continue  # noise landed the cluster gate below threshold
        assert out["fit_converged"][e, b], f"{family} fit failed on ({e},{b})"
        assert out["chi2"][e, b] >= 0
        assert abs(out["pedwf"][e, b] - ped) < 1.0
        expect_ns = (delta * cfg.dt - small_cal.cortime[b]
                     - small_cal.timerefacc * cfg.dt)
        assert abs(out["wftime"][e, b, 0] - expect_ns) < 0.5 * cfg.dt
        assert abs(out["wfampl"][e, b, 0] - amp) / amp < 0.15
        checked += 1
    assert checked >= 8, f"only {checked} truth lanes exercised"


def test_gaussian_beats_spline_on_gaussian_data(small_cfg, small_cal):
    """The matching family fits gaussian pulses with a lower chi2/ndf than
    the spline template."""
    sig, _ = _truth_batch(small_cfg, small_cal, "gaussian", seed=9)
    cg = _fit_port(small_cfg.replace(model_name="gaussian",
                                     model_aux=AUX["gaussian"]),
                   small_cal, sig)["chi2"]
    cs = _fit_port(small_cfg, small_cal, sig)["chi2"]
    both = (cg >= 0) & (cs >= 0)
    assert both.sum() >= 5
    assert np.median(cg[both]) < np.median(cs[both])


def test_model_aux_round_trips_through_json():
    cfg = TorchConfig(model_name="biexp", model_aux=AUX["biexp"])
    cfg2 = TorchConfig.from_json(cfg.to_json())
    assert cfg2 == cfg and hash(cfg2) == hash(cfg)
    assert get_model(cfg2.model_name).name == "biexp"


def test_cli_model_flag_parses():
    from npswf_tpu_torch.tools.cli import build_parser
    args = build_parser().parse_args(
        ["run", "--model", "gaussian", "--input", "x.npz", "--out", "y.npz",
         "--config", "c.json"])
    assert args.model == "gaussian" and args.config == "c.json"

"""The port's solver audit against the JAX package's, on the CPU at fp64.

``build_fit_inputs`` runs the pre-fit stages (K1 and K2's plain versions
here, the cluster gate, the error model) in torch; the fit runs on the
pipeline's model (the spline planes, K3's plain version here), where the
JAX tool runs its XLA while-loop on the gather model; the scipy-TRF
classification is the same host code.

The counts are compared on the wrong-shape ensemble. On the clean one a
marginal lane's convergence differs at fp64: the JAX package itself
decides it one way when it solves the lane at P = 12 (its audit) and the
other at P = 2 (its pipeline's bucket), as tests/test_torch_pipeline.py's
seed note describes; the port, whose masked columns add exact zeros,
decides it alike at every width. Comparing that ensemble would test the
JAX package's layouts, not the port.
"""
import numpy as np
import pytest
import torch

import npswf_tpu.tools.solver_audit as jax_audit
from npswf_tpu.core.calibration import synthetic_calibration as jax_calibration
from npswf_tpu.core.config import NPSConfig as JaxConfig
from npswf_tpu.utils.synthetic import adversarial_variants as jax_variants
from npswf_tpu.utils.synthetic import make_events as jax_make_events
from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.tools import cli
from npswf_tpu_torch.tools.solver_audit import audit_signal, build_fit_inputs
from npswf_tpu_torch.utils.synthetic import adversarial_variants, make_events

COUNTS = ("n_fits", "n_failed", "n_audited", "lm_stuck", "same_minimum",
          "lm_better")


@pytest.fixture(scope="module")
def ensembles():
    """solver_audit.main's ensembles at one event, fp64: the port's and the
    JAX package's (the same arrays), with the configs and calibrations."""
    cfg, jcfg = NPSConfig(compute_dtype="float64"), JaxConfig(compute_dtype="float64")
    cal, jcal = synthetic_calibration(cfg, seed=1), jax_calibration(jcfg, seed=1)
    truth = make_events(cfg, cal, 1, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    jtruth = jax_make_events(jcfg, jcal, 1, occupancy=1.0, max_pulses=2,
                             pileup_prob=0.25, seed=7)
    ens = {"clean": truth.signal, **adversarial_variants(cfg, cal, truth, 23)}
    jens = {"clean": jtruth.signal,
            **jax_variants(jcfg, jcal, jtruth, 23)}
    for k in ens:
        np.testing.assert_array_equal(ens[k], jens[k], err_msg=k)
    return cfg, cal, jcfg, jcal, ens, truth.pres


def test_adversarial_variants_equal_jax(ensembles):
    """The three stress ensembles are the JAX function's, array for array
    (checked in the fixture), and differ from the clean signal."""
    *_, ens, _ = ensembles
    assert list(ens) == ["clean", "wrong_shape", "correlated_noise", "clipped"]
    for k in ("wrong_shape", "correlated_noise", "clipped"):
        assert not np.array_equal(ens[k], ens["clean"])


def test_build_fit_inputs_matches_jax(ensembles):
    """Every fit problem equals the JAX tool's: the search's and the gate's
    decisions and the data exactly; sigma and the pedestal seed to
    summation-order rounding (a division turned into a multiplication, a
    mean)."""
    cfg, cal, jcfg, jcal, ens, pres = ensembles
    inp, npulse = build_fit_inputs(cfg, cal, ens["clean"], pres, "cpu")
    jinp, jnpulse = jax_audit.build_fit_inputs(jcfg, jcal, ens["clean"], pres)
    np.testing.assert_array_equal(npulse.numpy(), np.asarray(jnpulse))
    assert int(inp.active.sum()) == cal.nblocks
    for f in inp._fields:
        ours, ref = getattr(inp, f).numpy(), np.asarray(getattr(jinp, f))
        if f in ("sigma", "ped_seed"):
            # rounding of sums of samples: relative to the samples' scale
            np.testing.assert_allclose(
                ours, ref, rtol=1e-14,
                atol=1e-14 * np.abs(ens["clean"]).max(), err_msg=f)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=f)


def test_audit_counts_equal_jax(ensembles):
    """On the wrong-shape ensemble every fit fails or converges as in the
    JAX tool, and TRF classifies the failures alike."""
    cfg, cal, jcfg, jcal, ens, pres = ensembles
    ours = audit_signal(cfg, cal, ens["wrong_shape"], pres, sample=20,
                        device="cpu")
    ref = jax_audit.audit_signal(jcfg, jcal, ens["wrong_shape"], pres,
                                 sample=20)
    assert ours["n_failed"] > 0
    assert {k: ours[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}


def test_cli_solver_audit_needs_a_card_or_cpu(capsys):
    """Without a CUDA device solver-audit exits non-zero (no fallback);
    --cpu is the caller's choice."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["solver-audit", "--", "--events", "1"]) != 0
    assert "no CUDA device" in capsys.readouterr().err

"""The PyTorch port's process_batch against the JAX package at bucket
widths outside the defaults' 2, 4 and 12, on the CPU at fp64.

The batch and the comparison are tests/test_torch_pipeline.py's (which
has the seed note); these cases live in a file of their own so that
pytest-xdist's loadfile runs them beside that file, on another worker.
"""
import pytest
import torch

import tests.torch_threads  # noqa: F401 (one torch thread a process)
from tests.test_torch_pipeline import _assert_fp64_match, _run_both


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's outputs by (config, dtype, seed), once a module."""
    return {}


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
def test_process_batch_bucket_widths_match_jax_fp64(jax_refs, small_cfg, small_cal,
                                                   case):
    """Buckets of width 5, 10, 15 and 20 (a middle bound of 5; the wide
    bucket at maxwfpulses=10, and at 15 and 20 with pallas_lm_max_pulses
    raised with it: K3's widest compiled width, and its wide unit) carry
    lanes, and the default route matches the JAX package: decisions and
    counters exact, floats to 1e-9 relative."""
    changes, buckets = BUCKET_WIDTHS[case]
    ours, ref = _run_both(jax_refs, small_cfg.replace(**changes), small_cal,
                          torch.float64)
    n = ours["wfnpulse"][ours["gate"]]
    for width, lo, hi in buckets:
        assert ((n >= lo) & (n <= hi)).any(), f"bucket of width {width} empty"
    assert ours["fit_converged"].sum() >= 30
    _assert_fp64_match(ours, ref)

"""The port's copy of the host layer pinned to the JAX package's original.

``npswf_tpu_torch.core.config``, ``.core.calibration`` and
``.utils.synthetic`` are copies (the port imports nothing of the JAX
package): same fields and defaults, same arrays from the same seeds, and
every copied function and method identical in source.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import npswf_tpu.core.calibration as jax_calibration
import npswf_tpu.core.config as jax_config
import npswf_tpu.utils.synthetic as jax_synthetic
import npswf_tpu_torch.core.calibration as calibration
import npswf_tpu_torch.core.config as config
import npswf_tpu_torch.utils.synthetic as synthetic

PAIRS = [(config, jax_config), (calibration, jax_calibration),
         (synthetic, jax_synthetic)]


def _copied(module):
    """(qualified name, object) of each function, class and class member
    the copy defines in its source (a class may leave out members of its
    original; the methods a dataclass generates have no source)."""
    def written(fn):
        return inspect.isfunction(fn) and fn.__code__.co_filename == module.__file__
    for name, obj in vars(module).items():
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        if written(obj):
            yield name, obj
        elif inspect.isclass(obj):
            for attr, member in vars(obj).items():
                if written(getattr(member, "__func__", getattr(member, "fget", member))):
                    yield f"{name}.{attr}", member


COPIED = [(ours, ref, name) for ours, ref in PAIRS for name, _ in _copied(ours)]


def _lookup(module, qualname):
    obj = module
    for part in qualname.split("."):
        obj = inspect.getattr_static(obj, part)
    return getattr(obj, "__func__", getattr(obj, "fget", obj))


def test_config_fields_and_defaults():
    ours, ref = config.NPSConfig(), jax_config.NPSConfig()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.to_json() == ref.to_json()
    cfg = config.NPSConfig.from_json(ref.replace(maxwfpulses=8).to_json())
    assert cfg.max_params == 17 and cfg.nfitbins == ref.nfitbins
    for run in (1000, 2000, 4000, 6000):
        assert config.calodist_for_run(run) == jax_config.calodist_for_run(run)
        assert config.config_for_run(run).to_json() == \
            jax_config.config_for_run(run).to_json()


def _assert_same_fields(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


def test_synthetic_calibration_and_events_identical():
    small = dict(ncol=5, nlin=6)
    cfg, jcfg = config.NPSConfig(**small), jax_config.NPSConfig(**small)
    cal = calibration.synthetic_calibration(cfg, seed=4)
    jcal = jax_calibration.synthetic_calibration(jcfg, seed=4)
    _assert_same_fields(cal, jcal)
    arrays, jarrays = cal.device_arrays(cfg), jcal.device_arrays(jcfg)
    assert arrays.keys() == jarrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
    truth = synthetic.make_events(cfg, cal, 3, occupancy=0.5, max_pulses=3,
                                  pileup_prob=0.5, seed=6)
    jtruth = jax_synthetic.make_events(jcfg, jcal, 3, occupancy=0.5,
                                       max_pulses=3, pileup_prob=0.5, seed=6)
    for k, v in dataclasses.asdict(truth).items():
        np.testing.assert_array_equal(v, getattr(jtruth, k), err_msg=k)
    t = np.linspace(-5.0, 115.0, 97)
    np.testing.assert_array_equal(
        calibration.spline_eval_np(cal.spline_coeffs[3], cal.spline_x0[3], t),
        jax_calibration.spline_eval_np(cal.spline_coeffs[3], cal.spline_x0[3], t))


@pytest.mark.parametrize("ours,ref,name", COPIED,
                         ids=[f"{o.__name__.split('.')[-1]}.{n}"
                              for o, _, n in COPIED])
def test_copies_match_the_original_source(ours, ref, name):
    """Each function and method of a copy is its original, line for line."""
    assert inspect.getsource(_lookup(ours, name)) == \
        inspect.getsource(_lookup(ref, name))

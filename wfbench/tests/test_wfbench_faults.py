"""``correct`` comes out false when the timed path is broken underneath, for
each fault a cell can have, and under the control (the nearest precision
below the configuration's). A run here skips the look for a card and runs
the program's plain path on the CPU at a few events; the limits are the
cells' own. No cell crosses cards, so the fault of a left-out exchange
between cards has no cell to run in."""
import numpy as np
import pytest
import torch

from conftest import run_tiny, tiny_cell


def _fit_returns_its_start(cfg, model, inp, u0, lo, hi, p_seed, param_mask,
                           active, max_iter, lam0, iter_budget=None,
                           plain=False):
    """An LM stage that returns the state it was given, claiming success."""
    n = u0.shape[0]
    zero = torch.zeros((n,), dtype=u0.dtype, device=u0.device)
    return (u0, zero, active.clone(), torch.ones((n,), dtype=torch.int32),
            zero, zero)


def _half_batch(orig):
    """process_batch on the first half of the events, the second half's
    outputs taken from the first's."""
    def run(cfg, calib, batch, *a, **kw):
        E = batch.signal.shape[0]
        h = E // 2
        half = type(batch)(*(None if x is None else x[:h] for x in batch))
        out = orig(cfg, calib, half, *a, **kw)
        return type(out)(*(x if x.dim() == 0 else
                           torch.cat([x, x[:E - h]]) for x in out))
    return run


def _one_time_moved(orig):
    """process_batch with one pulse time moved by 0.01 bins where it is
    produced."""
    def run(cfg, calib, batch, *a, **kw):
        out = orig(cfg, calib, batch, *a, **kw)
        e, b = (int(v[0]) for v in torch.nonzero(out.wfnpulse > 0,
                                                 as_tuple=True))
        out.wftime[e, b, 0] += 0.01 * cfg.dt
        return out
    return run


def _decode_moved(orig):
    """The segment decode with one event's HMS correction moved by 1e-9."""
    def run(*a, **kw):
        d = orig(*a, **kw)
        d.corr_time_HMS[0] += 1e-9
        return d
    return run


def _part_left_out(orig):
    """The ordered merge with the first part file left out."""
    def run(part_paths, *a, **kw):
        return orig(list(part_paths)[1:], *a, **kw)
    return run


FAULTS = {
    "state_unchanged": ("npswf_tpu_torch.fit.lm.lm_solve",
                        lambda orig: _fit_returns_its_start),
    "half_batch": ("npswf_tpu_torch.engine.pipeline.process_batch",
                   _half_batch),
    "answer_altered": ("npswf_tpu_torch.engine.pipeline.process_batch",
                       _one_time_moved),
    "decode_altered": ("npswf_tpu_torch.runtime.executor.decode_segment",
                       _decode_moved),
    "part_left_out": ("npswf_tpu_torch.runtime.executor.merge_parts",
                      _part_left_out),
}


def _patch(monkeypatch, target, make):
    import importlib
    mod, name = target.rsplit(".", 1)
    module = importlib.import_module(mod)
    monkeypatch.setattr(module, name, make(getattr(module, name)))


@pytest.mark.parametrize("name,fault", [
    ("fp32.batch_dense", "state_unchanged"),
    ("fp32.batch_dense", "half_batch"),
    ("fp32.batch_dense", "answer_altered"),
    ("fp64.batch_dense", "answer_altered"),
    ("fp32.segment_sparse", "answer_altered"),
    ("fp32.segment_sparse", "decode_altered"),
    ("fp32.segment_sparse", "part_left_out"),
])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    target, make = FAULTS[fault]
    _patch(monkeypatch, target, make)
    out = run_tiny(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    if fault == "part_left_out":
        # the events of the part left out, whichever batches are sampled
        assert out["checks"]["events_unequal"]["value"] > 0


@pytest.mark.parametrize("name", ["fp32.batch_dense", "fp64.batch_dense",
                                  "fp32.segment_sparse"])
def test_the_control_is_not_correct(name):
    """The control's numbers, read as control.py reads them, fail the
    cell's limits."""
    from wfbench import compare, control
    cell = tiny_cell(name)
    nums = control.readings(cell, 2 ** 31 + 13, "control", 0.01,
                            torch.device("cpu"), workers=1)
    ok, rows = compare.verdict(nums, cell.limits)
    assert not ok, rows
    sound = control.readings(cell, 2 ** 31 + 13, "program", 0.01,
                             torch.device("cpu"), workers=1)
    assert compare.verdict(sound, cell.limits)[0], sound
    assert np.isfinite(list(sound.values())).all()

"""The port's host tools against the JAX package's, on the CPU.

The tools are copies (pinned by tests/test_torch_host.py), so these tests
run them on data the port produced and hold their results to the JAX
tools' on the same inputs: the parity harness (the analogues of
tests/test_parity.py), the ROOT bridges through a stubbed uproot
(tests/uproot_stub.py and tests/test_convert_root.py's fake file), the
template extraction, the Decimal fixture derivation, the CPU baseline and
the diagnostics pages. The CLI's subcommands run in process.
"""
import importlib.util
import json

import numpy as np
import pytest

from npswf_tpu_torch.io.rawstream import (build_segment, encode_event_stream,
                                          read_segment, write_segment)
from npswf_tpu_torch.runtime.executor import run_segment
from npswf_tpu_torch.tools import cli
from npswf_tpu_torch.tools import parity
from npswf_tpu_torch.tools.parity import compare, load_wf, load_wf_npz
from npswf_tpu_torch.utils.synthetic import make_events
from tests.test_convert_root import fake_root  # noqa: F401 (a fixture)
from tests.uproot_stub import install_stub

HAVE_MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None


def _segment(cfg, cal, E, seed, occupancy=0.3, max_pulses=2, **kw):
    """A raw segment of synthetic events (no hcana hits), events 1..E."""
    truth = make_events(cfg, cal, E, occupancy=occupancy,
                        max_pulses=max_pulses, seed=seed, **kw)
    streams = [encode_event_stream(cfg, truth.signal[e],
                                   truth.pres[e].astype(bool))
               for e in range(E)]
    hits = [{k: np.zeros(0) for k in
             ("adc_counter", "pulse_time", "pulse_time_raw",
              "pulse_amp", "pulse_int", "pulse_ped")} for _ in range(E)]
    return build_segment(cfg, streams, hits, evt=np.arange(1.0, E + 1.0),
                         runnum=np.full(E, 7.0))


@pytest.fixture(scope="module")
def wf_file(small_cfg, small_cal, tmp_path_factory):
    """A WF file the port wrote on the CPU (tests/test_parity.py's
    segment)."""
    out = str(tmp_path_factory.mktemp("parity") / "wf.npz")
    run_segment(small_cfg, small_cal, _segment(small_cfg, small_cal, 6, 11),
                out, batch_size=3, resume=False, device="cpu")
    return out


def _same(a, b, where="") -> None:
    """Nested dicts, sequences and arrays equal value for value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, where
        np.testing.assert_array_equal(x, y, err_msg=where)


# ---- parity ----------------------------------------------------------
def test_self_comparison_passes(wf_file):
    rep = compare(load_wf(wf_file), load_wf(wf_file))
    assert rep["pass"] and rep["events_aligned"] == 6
    assert rep["time_q95_bins"] == 0.0 and rep["amp_rel_q95"] == 0.0
    assert rep["npulse_mismatch"] == 0 and rep["fit_status_mismatch"] == 0
    assert rep["pulses_compared"] > 0


def test_time_shift_fails_the_bar(wf_file):
    ref, ours = load_wf_npz(wf_file), load_wf_npz(wf_file)
    ours.wftime = ours.wftime + 0.1 * 4.0   # +0.1 bins in ns
    rep = compare(ref, ours)
    assert not rep["pass"] and abs(rep["time_q95_bins"] - 0.1) < 1e-9
    ours.wftime = ref.wftime + 0.01 * 4.0
    rep2 = compare(ref, ours)
    assert rep2["pass"] and abs(rep2["time_q50_bins"] - 0.01) < 1e-9


def test_npulse_and_status_mismatches_counted(wf_file):
    ref, ours = load_wf_npz(wf_file), load_wf_npz(wf_file)
    ours.wfnpulse = ours.wfnpulse.copy()
    lanes = np.argwhere(ours.wfnpulse > 0)
    ours.wfnpulse[tuple(lanes[0])] += 1
    ours.chi2 = ours.chi2.copy()
    ours.chi2[tuple(lanes[1])] = -100.0     # one lane flipped to fit-failed
    rep = compare(ref, ours)
    assert rep["npulse_mismatch"] == 1 and rep["fit_status_mismatch"] == 1


def test_partial_event_overlap(wf_file):
    ref, ours = load_wf_npz(wf_file), load_wf_npz(wf_file)
    ours.evt = ours.evt.copy()
    ours.evt[0] = 999.0
    assert compare(ref, ours)["events_aligned"] == 5


def test_root_wf_loader_with_stubbed_uproot(wf_file, monkeypatch, tmp_path):
    """load_wf_root reads the reference Snapshot schema through uproot's
    library='np' object arrays."""
    import sys
    import types
    ours = load_wf_npz(wf_file)
    E = ours.wfnpulse.shape[0]

    def rows(flat):
        return np.asarray([flat[ours.offsets[i]:ours.offsets[i + 1]]
                           for i in range(E)], object)
    branches = {"evt": ours.evt, "runnum": ours.runnum,
                "wfnpulse": np.asarray(list(ours.wfnpulse), object),
                "chi2": np.asarray(list(ours.chi2), object),
                "wftime": rows(ours.wftime), "wfampl": rows(ours.wfampl)}

    class FakeFile:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def __getitem__(self, k):
            assert k == "WF"
            return types.SimpleNamespace(
                arrays=lambda names, library="np": {n: branches[n]
                                                    for n in names})
    stub = types.ModuleType("uproot")
    stub.open = lambda path: FakeFile()
    monkeypatch.setitem(sys.modules, "uproot", stub)
    fake = tmp_path / "ref_wf.root"
    fake.write_bytes(b"stub")
    rep = compare(load_wf(str(fake)), ours)
    assert rep["pass"] and rep["time_q95_bins"] == 0.0


def test_parity_report_equals_jax(wf_file):
    """The port's report on a perturbed copy is the JAX tool's, key for key."""
    from npswf_tpu.tools import parity as jax_parity
    reports = []
    for mod in (jax_parity, parity):
        ref, ours = mod.load_wf_npz(wf_file), mod.load_wf_npz(wf_file)
        ours.wftime = ours.wftime + np.linspace(0.0, 0.3, ours.wftime.size)
        reports.append(mod.compare(ref, ours))
    _same(*reports)


def test_cli_parity_exit_codes(wf_file, tmp_path):
    """parity exits 0 on the file against itself and 1 once every wftime
    moves by 0.2 bins; --json writes the report."""
    shifted = str(tmp_path / "shifted.npz")
    with np.load(wf_file, allow_pickle=False) as z:
        cols = dict(z)
    cols["wftime_flat"] = cols["wftime_flat"] + 0.2 * 4.0
    np.savez(shifted, **cols)
    report = str(tmp_path / "rep.json")
    assert cli.main(["parity", "--ref", wf_file, "--ours", wf_file,
                     "--json", report]) == 0
    assert json.load(open(report))["pass"]
    assert cli.main(["parity", "--ref", wf_file, "--ours", shifted]) == 1


# ---- the ROOT bridges ------------------------------------------------
def test_convert_root_equals_jax(fake_root, tmp_path):  # noqa: F811
    """convert-root (stubbed uproot) writes the JAX tool's segment, field
    for field and payload column for column, whole and with entry_stop;
    a missing input exits."""
    from npswf_tpu.tools.convert_root import convert as jax_convert
    from npswf_tpu_torch.tools.convert_root import convert
    input_path, truth = fake_root
    for stop in (None, 2):
        ours, ref = (str(tmp_path / f"{n}{stop}.npz") for n in ("o", "r"))
        n = convert(input_path, ours, stop)
        assert n == jax_convert(input_path, ref, stop) == (stop or truth["E"])
        a, b = read_segment(ours), read_segment(ref)
        assert a.n_events == n
        for f in ("stream", "stream_offsets", "hit_offsets", "evt", "runnum",
                  "pulse_amp"):
            _same(getattr(a, f), getattr(b, f), f)
        _same(a.payload, b.payload, "payload")
    with pytest.raises(SystemExit, match="Cannot open file"):
        convert(str(tmp_path / "missing.root"), str(tmp_path / "never.npz"))


def test_cli_convert_root(fake_root, tmp_path):  # noqa: F811
    input_path, truth = fake_root
    out = str(tmp_path / "seg.npz")
    assert cli.main(["convert-root", "--", input_path, out]) == 0
    assert read_segment(out).n_events == truth["E"]


def test_convert_wf_root_equals_jax(monkeypatch, tmp_path, wf_file):
    """convert-wf-root (uproot_stub) writes the JAX tool's trees and
    histograms from the port's WF file, and an empty WF file converts."""
    from npswf_tpu.tools.convert_wf_to_root import convert as jax_convert
    from npswf_tpu_torch.io.writer import write_empty_wf
    from npswf_tpu_torch.tools.convert_wf_to_root import (REFERENCE_BRANCHES,
                                                          convert)
    files = install_stub(monkeypatch)
    ours, ref = str(tmp_path / "ours.root"), str(tmp_path / "ref.root")
    assert convert(wf_file, ours) == jax_convert(wf_file, ref) == 6
    for b in REFERENCE_BRANCHES:
        assert b in files[ours].written["WF"]
    _same(files[ours].written, files[ref].written)
    empty = str(tmp_path / "empty.npz")
    write_empty_wf(empty)
    assert cli.main(["convert-wf-root", "--", empty,
                     str(tmp_path / "e.root")]) == 0


# ---- template extraction ---------------------------------------------
def test_extract_templates_equals_jax(small_cfg, small_cal, tmp_path,
                                      monkeypatch):
    """extract-templates on one segment file (the CLI, numpy decode) gives
    the JAX tool's calibration bundle, array for array."""
    from npswf_tpu.core.calibration import CalibrationBundle as JaxBundle
    from npswf_tpu.tools import extract_templates as jax_tool
    from npswf_tpu_torch.core.calibration import CalibrationBundle
    seg_path = str(tmp_path / "seg.npz")
    write_segment(seg_path, _segment(small_cfg, small_cal, 32, 16,
                                     occupancy=1.0, max_pulses=1, noise=0.4,
                                     amp_range=(40.0, 200.0)))
    # config_for_run would build the full 1080-block geometry
    monkeypatch.setattr("npswf_tpu_torch.core.config.config_for_run",
                        lambda run: small_cfg)
    monkeypatch.setattr("npswf_tpu.core.config.config_for_run",
                        lambda run: small_cfg)
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    assert cli.main(["extract-templates", "--", seg_path, ours,
                     "--no-native"]) == 0
    assert jax_tool.main([seg_path, ref, "--no-native"]) == 0
    a, b = CalibrationBundle.load(ours), JaxBundle.load(ref)
    assert a.preswf.sum() == small_cfg.nblocks
    for f in ("interp_y", "timeref", "mfkern_rev", "mfint", "spline_coeffs",
              "spline_x0", "preswf", "cortime"):
        _same(getattr(a, f), getattr(b, f), f)


# ---- fixtures, baseline, diagnostics --------------------------------
def test_derive_fixtures_reproduces_the_committed_file(capsys):
    """The Decimal oracle re-derives tests/data/searchhighres_fixtures.json
    exactly (derive-fixtures --check)."""
    assert cli.main(["derive-fixtures", "--", "--check"]) == 0
    assert "fixtures up to date" in capsys.readouterr().out


def test_cpu_baseline_small_sample(cfg, cal):
    """The analogue of tests/test_cpu_baseline.py, min_blocks=4."""
    from npswf_tpu_torch.tools.cpu_baseline import measure_cpu_baseline
    truth = make_events(cfg, cal, 1, occupancy=1.0, max_pulses=2,
                        pileup_prob=0.25, seed=7)
    res = measure_cpu_baseline(cfg, cal, truth.signal,
                               np.asarray(cal.timeref, dtype=np.float64),
                               time_budget_s=0.5, min_blocks=4)
    assert res["n_blocks"] >= 4 and res["n_fitted"] >= 1
    assert res["blocks_per_sec_1thread"] > 0
    assert res["blocks_per_sec_4thread"] == pytest.approx(
        4.0 * res["blocks_per_sec_1thread"])
    assert np.isfinite(res["mean_chi2"]) and res["mean_chi2"] > 0
    assert res["search_ms_per_block"] > 0 and res["fit_ms_per_block"] > 0


def test_cli_cpu_baseline(capsys):
    assert cli.main(["cpu-baseline", "--", "--time-budget-s", "0.1",
                     "--min-blocks", "2"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["seeds"] == [7, 19, 41]
    assert res["blocks_per_sec_4thread"]["min"] > 0


@pytest.mark.skipif(not HAVE_MATPLOTLIB, reason="diagnostics needs matplotlib")
def test_diagnostics_pages_equal_jax(cfg, cal, tmp_path):
    """diagnostics (Agg) draws the pages the JAX tool draws, by name, from
    a WF file the port wrote for the full calorimeter."""
    from npswf_tpu.tools.diagnostics import make_event_plots as jax_plots
    seg_path, cal_path, wf_path = (str(tmp_path / n) for n in
                                   ("seg.npz", "cal.npz", "wf.npz"))
    seg = _segment(cfg, cal, 2, 5, occupancy=0.01)
    write_segment(seg_path, seg)
    cal.save(cal_path)
    run_segment(cfg, cal, seg, wf_path, batch_size=2, resume=False,
                device="cpu")
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert cli.main(["diagnostics", wf_path, "--input", seg_path, "--calib",
                     cal_path, "--outdir", str(ours)]) == 0
    n = jax_plots(wf_path, seg_path, cal_path, str(ref))
    assert n == 2
    assert sorted(p.name for p in ours.iterdir()) == \
        sorted(p.name for p in ref.iterdir()) == ["fits_evt1.png",
                                                  "fits_evt2.png"]


def test_cli_diagnostics_without_matplotlib(monkeypatch, capsys):
    """Without matplotlib the subcommand exits non-zero and says why."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    assert cli.main(["diagnostics", "wf.npz", "--input", "s.npz",
                     "--calib", "c.npz"]) != 0
    assert "matplotlib" in capsys.readouterr().err


def test_cli_lists_every_subcommand(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = capsys.readouterr().out
    for name in ("run", "synth", "validate", "parity", "diagnostics",
                 "convert-root", "convert-wf-root", "solver-audit",
                 "cpu-baseline", "derive-fixtures", "extract-templates",
                 "e2e-bench", "glue-profile", "perf-probe", "measure-link"):
        assert name in text
    # every subcommand of the JAX package's CLI
    from npswf_tpu.tools.cli import build_parser as jax_parser
    sub = [a for a in jax_parser()._actions
           if isinstance(a, __import__("argparse")._SubParsersAction)][0]
    assert set(sub.choices) <= set(cli._DELEGATED) | {
        "run", "synth", "validate", "parity", "diagnostics"}

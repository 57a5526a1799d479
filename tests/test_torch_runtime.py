"""The port's segment executor and CLI against the JAX package's, on the CPU.

Two segments go through both packages' ``run_segment`` (batch 4, so the
tail batch of 13 events is padded):

- ``synth``: the CLI's synthetic segment (13 events, occupancy 0.03, seed
  3, every block read out) under ``config_for_run(3000)``, the full
  1080-block layout: the dense writer packet;
- ``sparse``: 13 events of the 6x5 grid read out where they have pulses
  (up to 2 a block): the slab packet and the present-lane upload.

At fp64 every integer, offset, index, counter and decode-side column is
equal and every float column within one fp32 ulp of the packet
(rtol = atol = 1e-6). At fp32 the bands of
tests/test_torch_pipeline.py::test_process_batch_matches_jax_fp32 hold at
the file's level (see ``_assert_fp32_band``). Seed note: on these seeds the
JAX package's files agree with the port's byte for byte at fp64, so the
tolerance is not hiding a difference of the JAX package with itself.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from npswf_tpu.core.calibration import CalibrationBundle as JaxCalibration
from npswf_tpu.core.config import NPSConfig as JaxConfig
from npswf_tpu.io.rawstream import read_segment as jax_read_segment
from npswf_tpu.runtime.executor import run_segment as jax_run_segment
from npswf_tpu.tools.cli import main as jax_cli
import npswf_tpu_torch.runtime.executor as executor
from npswf_tpu_torch.core.calibration import (CalibrationBundle,
                                              synthetic_calibration)
from npswf_tpu_torch.core.config import NPSConfig, config_for_run
from npswf_tpu_torch.io.rawstream import build_segment, read_segment, write_segment
from npswf_tpu_torch.io.writer import read_wf
from npswf_tpu_torch.runtime.executor import run_segment
from npswf_tpu_torch.tools.cli import main as cli_main, synth_records
from npswf_tpu_torch.tools.plotstats import validate
from npswf_tpu_torch.utils.synthetic import make_events
import tests.torch_threads  # noqa: F401 (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
DECODE_COLS = ("pres", "corr_time_HMS", "Sampampl", "Samptime", "Sampener",
               "Sampped", "evt", "runnum")
EXACT = DECODE_COLS + ("wfnpulse", "search_overflow", "wf_offsets", "sort_order")
EXACT_FP64 = EXACT + ("h_offsets", "fit_counters", "h1time_hist", "h2time_hist")
LANE_FLOATS = ("chi2", "amplwf", "timewf", "pedwf")


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """name -> (config JSON, segment path, calibration path)."""
    d = tmp_path_factory.mktemp("segments")
    out = {}
    seg, cal = str(d / "synth.npz"), str(d / "synth_cal.npz")
    assert cli_main(["synth", "--events", "13", "--occupancy", "0.03",
                     "--out", seg, "--calib-out", cal, "--seed", "3"]) == 0
    out["synth"] = (config_for_run(3000).to_json(), seg, cal)
    cfg = NPSConfig(ncol=5, nlin=6, maxwfpulses=2)
    cal_s = synthetic_calibration(cfg, seed=2)
    truth = make_events(cfg, cal_s, 13, occupancy=0.15, max_pulses=2,
                        pileup_prob=0.5, seed=5)
    streams, hits = synth_records(cfg, truth, np.random.default_rng(6),
                                  pres=truth.npulse > 0)
    seg = str(d / "sparse.npz")
    write_segment(seg, build_segment(cfg, streams, hits,
                                     evt=np.arange(1, 14, dtype=np.float64),
                                     runnum=np.full(13, 3000.0)))
    cal_s.save(str(d / "sparse_cal.npz"))
    out["sparse"] = (cfg.to_json(), seg, str(d / "sparse_cal.npz"))
    return out


def _cfg(segments, name, dtype="float32"):
    return NPSConfig.from_json(segments[name][0]).replace(compute_dtype=dtype)


def _port_run(segments, name, out, dtype="float32", **kw):
    _, seg, cal = segments[name]
    res = run_segment(_cfg(segments, name, dtype), CalibrationBundle.load(cal),
                      read_segment(seg), str(out), batch_size=BATCH,
                      device="cpu", **kw)
    return res, read_wf(str(out))


_JAX_WF = {}


def _jax_wf(segments, name, dtype, tmp_path):
    """The JAX package's WF file of a segment (one run per segment and
    dtype in this module)."""
    if (name, dtype) not in _JAX_WF:
        cfg_json, seg, cal = segments[name]
        out = str(tmp_path / f"jax_{name}_{dtype}.npz")
        jax_run_segment(JaxConfig.from_json(cfg_json).replace(compute_dtype=dtype),
                        JaxCalibration.load(cal), jax_read_segment(seg), out,
                        batch_size=BATCH)
        _JAX_WF[name, dtype] = read_wf(out)
    return _JAX_WF[name, dtype]


def test_synth_matches_jax(segments, tmp_path):
    """The port's synth writes the JAX CLI's segment and calibration."""
    _, seg, cal = segments["synth"]
    jseg, jcal = str(tmp_path / "s.npz"), str(tmp_path / "c.npz")
    assert jax_cli(["synth", "--events", "13", "--occupancy", "0.03",
                    "--out", jseg, "--calib-out", jcal, "--seed", "3"]) == 0
    for ours, ref in ((seg, jseg), (cal, jcal)):
        a, b = np.load(ours), np.load(ref)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _lanes(wf, values):
    """Per-lane values repeated over each lane's pulses (flat order)."""
    return np.repeat(values.reshape(-1), wf["wfnpulse"].reshape(-1))


def _assert_fp32_band(ours, ref, dt_ns):
    """fp32 at the file's level: the search, the decode and the index are
    exact; convergence (chi2 != -100) flips on at most max(4, 2%) of the
    converged lanes; lanes that converged on both sides agree to fp32
    rounding (chi2, amplwf, timewf, pedwf within rtol 1e-4, atol 1e-3)
    except at most as many again, whose fits took another trajectory; the
    pulse times of lanes converged on both sides agree to 0.05 bins at the
    90% quantile; every other difference (h1/h2 entries and histograms,
    fit counters) lies on the lanes that flipped or took another
    trajectory."""
    for k in EXACT:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("ampl", "enertot", "integtot"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-3, err_msg=k)
    conv_o, conv_r = ours["chi2"] != -100.0, ref["chi2"] != -100.0
    n_conv = int(conv_r.sum())
    band = max(4, int(0.02 * n_conv))
    flips = conv_o != conv_r
    assert n_conv > 0 and int(flips.sum()) <= band
    both = conv_o & conv_r
    off = np.zeros_like(both)
    for k in LANE_FLOATS:
        off |= ~np.isclose(ours[k], ref[k], rtol=1e-4, atol=1e-3)
    off &= both
    assert int(off.sum()) <= band
    differ = flips | off
    same = ~differ
    for k in ("wftime_flat", "wfampl_flat"):
        keep = _lanes(ref, same)
        np.testing.assert_allclose(ours[k][keep], ref[k][keep], rtol=1e-4,
                                   atol=1e-3, err_msg=k)
    pulses_both = _lanes(ref, both)
    dt_bins = np.abs(ours["wftime_flat"] - ref["wftime_flat"])[pulses_both] / dt_ns
    assert np.quantile(dt_bins, 0.9) < 0.05
    moved = int(ref["wfnpulse"][differ].sum())
    assert abs(int(ours["h_offsets"][-1]) - int(ref["h_offsets"][-1])) <= moved
    for k in ("h1time_hist", "h2time_hist"):
        assert int(np.abs(ours[k] - ref[k]).sum()) <= 2 * moved, k
    fc_o, fc_r = ours["fit_counters"], ref["fit_counters"]
    np.testing.assert_array_equal(fc_o[2:], fc_r[2:])
    assert abs(int(fc_o[0]) - int(fc_r[0])) <= int(flips.sum())
    assert int(fc_o[0] + fc_o[1]) == int(fc_r[0] + fc_r[1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["synth", "sparse"])
def test_run_segment_matches_jax(segments, name, dtype, tmp_path):
    """The WF file of the port's run_segment(device="cpu") against the JAX
    package's on the same segment and calibration."""
    cfg = _cfg(segments, name)
    _, seg, cal = segments[name]
    d0 = executor.decode_segment(cfg, CalibrationBundle.load(cal),
                                 read_segment(seg), 0, BATCH)
    lane_cap = executor.packet_caps(BATCH, cfg.nblocks,
                                    int(d0.pres[:, :cfg.nblocks].sum()))[1]
    assert (lane_cap > 0) == (name == "sparse")        # slab or dense packet
    ref = _jax_wf(segments, name, dtype, tmp_path)
    res, ours = _port_run(segments, name, tmp_path / "wf.npz", dtype)
    assert sorted(ours) == sorted(ref)
    assert res.n_events == 13 and ref["evt"].shape[0] == 13
    assert validate(ours) == 0
    assert ours["wf_offsets"][-1] == ours["wfnpulse"].sum() > 0
    assert res.n_fit_success == ours["fit_counters"][0] > 0
    if dtype == "float64":
        for k in ref:
            if k in EXACT_FP64:
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
            else:
                np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
    else:
        _assert_fp32_band(ours, ref, _cfg(segments, name).dt)


@pytest.mark.parametrize("name", ["synth", "sparse"])
def test_upload_equals_the_plain_conversion(segments, name):
    """_upload_batch (the whole signal of a full synth batch; the present
    rows only of a padded sparse one; the small fields in one array) gives
    the EventBatch of the plain per-field conversion, at fp64 and fp32."""
    cfg = _cfg(segments, name)
    _, seg, cal = segments[name]
    lo, hi = (0, BATCH) if name == "synth" else (12, 13)
    d = executor._pad_decoded(cfg, executor.decode_segment(
        cfg, CalibrationBundle.load(cal), read_segment(seg), lo, hi), BATCH)
    n_pres = int(d.pres[:, :cfg.nblocks].sum())
    assert (n_pres <= BATCH * cfg.nblocks // 2) == (name == "sparse")
    for dtype in (torch.float64, torch.float32):
        up = executor._upload_batch(cfg, d, dtype, torch.device("cpu"))
        ref = executor._to_event_batch(cfg, d, dtype, "cpu")
        for f in ref._fields:
            a, b = getattr(up, f), getattr(ref, f)
            assert a.dtype == b.dtype or f in ("evt", "runnum"), f
            assert torch.equal(a.to(b.dtype), b), f


def _same_file(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


_PLAIN = {}


def _plain(segments, name, tmp_path):
    if name not in _PLAIN:
        _PLAIN[name] = _port_run(segments, name, tmp_path / f"plain_{name}.npz")[1]
    return _PLAIN[name]


@pytest.mark.parametrize("k", [2, 3])
def test_chained_matches_unchained(segments, tmp_path, k):
    """chain_batches = 2 (two chains of two) and 3 (a chain of three and a
    one-batch tail) write the plain run's file."""
    _, wf = _port_run(segments, "sparse", tmp_path / "wf.npz", chain_batches=k)
    _same_file(wf, _plain(segments, "sparse", tmp_path))


def test_resume_after_crash(segments, tmp_path, monkeypatch):
    """A crash in the third decode leaves a resumable sidecar; the rerun
    skips the completed batches and writes the plain run's file."""
    out = tmp_path / "wf.npz"
    orig = executor.decode_segment
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return orig(*a, **k)

    monkeypatch.setattr(executor, "decode_segment", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        _port_run(segments, "sparse", out)
    monkeypatch.setattr(executor, "decode_segment", orig)
    assert os.path.exists(str(out) + ".progress.json")
    done = len(os.listdir(str(out) + ".parts"))
    assert 0 < done < 4
    decoded = []
    monkeypatch.setattr(executor, "decode_segment",
                        lambda *a, **k: decoded.append(a[3]) or orig(*a, **k))
    _, wf = _port_run(segments, "sparse", out)
    assert len(decoded) == 4 - done
    _same_file(wf, _plain(segments, "sparse", tmp_path))
    assert not os.path.exists(str(out) + ".progress.json")
    assert not os.path.isdir(str(out) + ".parts")


@pytest.mark.parametrize("caps", [(2, 2), (2, 0)], ids=["lanes", "elements"])
def test_dense_fallback_gives_the_same_file(segments, tmp_path, monkeypatch,
                                            caps):
    """Packets sized too small (two present lanes, or two pulses) send
    batches through the dense path, whose host copy the writer takes: the
    file is the plain run's (fp32: the packet stores fp32 too)."""
    monkeypatch.setattr(executor, "packet_caps", lambda *a: caps)
    dense = []
    orig = executor.output_to_host
    monkeypatch.setattr(executor, "output_to_host",
                        lambda out: dense.append(1) or orig(out))
    _, wf = _port_run(segments, "sparse", tmp_path / "wf.npz")
    assert len(dense) == 4
    _same_file(wf, _plain(segments, "sparse", tmp_path))


def test_dense_fallback_at_fp64_writes_the_packet_values(segments, tmp_path,
                                                         monkeypatch):
    """At fp64 too the dense path's batches write the packet's fp32
    values: the file equals the packet run's."""
    packet = _port_run(segments, "sparse", tmp_path / "packet.npz",
                       dtype="float64")[1]
    monkeypatch.setattr(executor, "packet_caps", lambda *a: (2, 2))
    _, wf = _port_run(segments, "sparse", tmp_path / "wf.npz",
                      dtype="float64")
    _same_file(wf, packet)


def test_empty_and_single_event_segments(small_cfg, tmp_path):
    cfg = NPSConfig.from_json(small_cfg.to_json())
    cal = synthetic_calibration(cfg, seed=2)
    seg0 = build_segment(cfg, [], [], evt=np.zeros(0), runnum=np.zeros(0))
    res0 = run_segment(cfg, cal, seg0, str(tmp_path / "e.npz"), batch_size=4,
                       device="cpu")
    assert res0.n_events == 0 and res0.n_fit_success == 0
    wf0 = read_wf(str(tmp_path / "e.npz"))
    assert wf0["evt"].shape[0] == 0 and validate(wf0) == 0
    truth = make_events(cfg, cal, 1, occupancy=0.5, seed=3)
    streams, hits = synth_records(cfg, truth, np.random.default_rng(4))
    seg1 = build_segment(cfg, streams, hits, evt=np.asarray([7.0]),
                         runnum=np.asarray([3000.0]))
    res1 = run_segment(cfg, cal, seg1, str(tmp_path / "one.npz"), batch_size=4,
                       device="cpu")
    wf1 = read_wf(str(tmp_path / "one.npz"))
    assert res1.n_events == 1 and int(wf1["evt"][0]) == 7
    assert res1.n_fit_success > 0


def test_run_segment_needs_a_card_unless_the_cpu_is_asked_for(segments, tmp_path):
    """No CPU fallback: without a card device="cuda" (the default) raises;
    a mesh on cards the machine lacks is refused when it is made; the
    profile goes to a Chrome trace."""
    from npswf_tpu_torch.parallel.mesh import make_mesh
    _, seg, cal = segments["sparse"]
    args = (_cfg(segments, "sparse"), CalibrationBundle.load(cal),
            read_segment(seg), str(tmp_path / "wf.npz"))
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n_cards + 1} devices"):
        run_segment(*args, mesh=make_mesh(args[0], n_data=n_cards + 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_segment(*args)
    assert not os.path.exists(args[-1])
    run_segment(*args, batch_size=8, device="cpu",
                profile_dir=str(tmp_path / "prof"))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def _cli(*argv, env=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([sys.executable, "-m", "npswf_tpu_torch.tools.cli",
                           *argv], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)


def test_cli_subprocess_end_to_end(tmp_path):
    """synth -> run --cpu -> validate in clean interpreters."""
    seg, cal, out = (str(tmp_path / n) for n in ("s.npz", "c.npz", "o.npz"))
    r1 = _cli("synth", "--events", "3", "--out", seg, "--calib-out", cal)
    assert r1.returncode == 0, r1.stderr
    r2 = _cli("run", "--input", seg, "--calib", cal, "--out", out,
              "--batch-size", "4", "--cpu")
    assert r2.returncode == 0, r2.stderr
    assert "fits succeed" in r2.stdout
    r3 = _cli("validate", out)
    assert r3.returncode == 0, r3.stdout + r3.stderr
    assert "index OK" in r3.stdout


def test_cli_run_without_a_card_fails(segments, tmp_path):
    """run without --cpu and without a visible card exits non-zero with a
    message and writes no file; --devices 2 without two cards raises, and
    --cpu --devices 2 runs two gloo ranks to the single device's file."""
    _, seg, cal = segments["sparse"]
    out = str(tmp_path / "o.npz")
    r = _cli("run", "--input", seg, "--calib", cal, "--out", out,
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not os.path.exists(out) and not os.path.exists(out + ".parts")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="need 2 devices"):
            cli_main(["run", "--input", seg, "--calib", cal, "--out", out,
                      "--devices", "2"])
    _, seg, cal = segments["synth"]
    one, two = str(tmp_path / "one.npz"), str(tmp_path / "two.npz")
    for path, more in ((one, []), (two, ["--devices", "2"])):
        assert cli_main(["run", "--input", seg, "--calib", cal, "--out", path,
                         "--batch-size", "8", "--cpu", *more]) == 0
    with open(one, "rb") as a, open(two, "rb") as b:
        assert a.read() == b.read()

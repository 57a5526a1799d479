"""The port's host I/O and writer packets against the JAX package, on the CPU.

Decode: the port's ``decode_segment`` (native C++ and numpy) equals the JAX
package's on every field of a segment with scintillator channels, a sparse
readout and bad-slot, truncated and oversize events; the decode layout is
that of the full 1080-block calorimeter (the scintillator slots remap past
block 1079). Packets: one JAX ``PipelineOutput`` at fp32 and at fp64, handed
to the port as tensors, serializes to the JAX package's buffers bit for bit,
dense and slab; the port's chains equal single calls bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npswf_tpu.engine.pipeline as jax_pipeline
from npswf_tpu.io.decode import decode_segment as jax_decode_segment
from npswf_tpu.io.rawstream import read_segment as jax_read_segment
from npswf_tpu.utils.synthetic import make_events as jax_make_events
from npswf_tpu_torch.core.calibration import (CalibrationBundle,
                                              synthetic_calibration)
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine import pipeline
from npswf_tpu_torch.io import native
from npswf_tpu_torch.io.decode import decode_segment
from npswf_tpu_torch.io.rawstream import (build_segment, encode_event_stream,
                                          read_segment, write_segment)
from npswf_tpu_torch.io.writer import WFWriter, flatten_pulses, flatten_pulses_np
from npswf_tpu_torch.runtime.executor import output_to_host
from npswf_tpu_torch.utils.synthetic import make_events
import tests.torch_threads  # noqa: F401 (one torch thread a process)

HIT_FIELDS = ("adc_counter", "pulse_time", "pulse_time_raw", "pulse_amp",
              "pulse_int", "pulse_ped")


def _no_hits():
    return {k: np.zeros(0) for k in HIT_FIELDS}


@pytest.fixture(scope="module")
def full():
    cfg = NPSConfig()
    return cfg, synthetic_calibration(cfg, seed=1)


def _segment(cfg, cal, E=5, seed=41):
    """Synthetic events with scintillator channels on even events and a
    sparse readout, then an event with an out-of-range slot, one whose
    last block runs past its stream, and one above the Ndata guard."""
    truth = make_events(cfg, cal, E, occupancy=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    pres = truth.pres.astype(bool) & (rng.random(truth.pres.shape) < 0.7)
    streams, hits = [], []
    for e in range(E):
        scint = rng.standard_normal((2, cfg.ntime)) if e % 2 == 0 else None
        streams.append(encode_event_stream(cfg, truth.signal[e], pres[e], scint))
        nb = np.nonzero(truth.npulse[e])[0]
        hits.append({"adc_counter": nb.astype(np.float64),
                     "pulse_time": rng.uniform(100, 200, nb.size),
                     "pulse_time_raw": rng.uniform(0, 4000, nb.size),
                     "pulse_amp": rng.uniform(10, 100, nb.size),
                     "pulse_int": rng.uniform(10, 100, nb.size),
                     "pulse_ped": rng.uniform(-2, 2, nb.size)})
    T = cfg.ntime
    streams.append(np.concatenate([
        [5.0, T], np.ones(T), [3000.0, T], np.ones(T), [7.0, T], 2 * np.ones(T)]))
    streams.append(np.concatenate([[4.0, T], np.arange(T), [9.0, T], np.ones(20)]))
    streams.append(np.ones(cfg.ndata_max + 1))
    hits += [_no_hits()] * 3
    n = len(streams)
    return build_segment(cfg, streams, hits,
                         evt=np.arange(1, n + 1, dtype=np.float64),
                         runnum=np.full(n, 3000.0),
                         payload={"meta": np.array([1, 2, 3])})


@pytest.fixture(scope="module")
def segment_files(full, tmp_path_factory):
    cfg, cal = full
    d = tmp_path_factory.mktemp("io")
    write_segment(str(d / "seg.npz"), _segment(cfg, cal))
    cal.save(str(d / "cal.npz"))
    return str(d / "seg.npz"), str(d / "cal.npz")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_decode_matches_jax(full, segment_files, use_native):
    """Every field of the port's decode equals the JAX package's native
    decode, the three guard events included."""
    from npswf_tpu.core.calibration import CalibrationBundle as JaxCalibration
    from npswf_tpu.core.config import NPSConfig as JaxConfig
    cfg, _ = full
    seg_path, cal_path = segment_files
    ours = decode_segment(cfg, CalibrationBundle.load(cal_path),
                          read_segment(seg_path), use_native=use_native)
    ref = jax_decode_segment(JaxConfig.from_json(cfg.to_json()),
                             JaxCalibration.load(cal_path),
                             jax_read_segment(seg_path), use_native=True)
    assert list(ours.bad_slot[-3:]) == [3000, -2, -3]
    assert (ours.pres[:5, cfg.nblocks:cfg.nblocks + 2] == 1).any()
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert a.dtype == b.dtype, f.name


def test_segment_and_calibration_files_read_by_both(full, segment_files):
    """A segment and a calibration written by the port read back the same
    in both packages (the CLI's --calib and synth --calib-out)."""
    from npswf_tpu.core.calibration import CalibrationBundle as JaxCalibration
    cfg, cal = full
    seg_path, cal_path = segment_files
    ours, ref = read_segment(seg_path), jax_read_segment(seg_path)
    for f in dataclasses.fields(ref):
        if f.name == "payload":
            np.testing.assert_array_equal(ours.payload["meta"], ref.payload["meta"])
        else:
            np.testing.assert_array_equal(getattr(ours, f.name),
                                          getattr(ref, f.name), err_msg=f.name)
    mine, theirs = CalibrationBundle.load(cal_path), JaxCalibration.load(cal_path)
    for f in dataclasses.fields(theirs):
        np.testing.assert_array_equal(getattr(mine, f.name),
                                      getattr(theirs, f.name), err_msg=f.name)
        np.testing.assert_array_equal(getattr(mine, f.name),
                                      getattr(cal, f.name), err_msg=f.name)
    sub = ours.slice(1, 3)
    np.testing.assert_array_equal(sub.event_stream(0), ours.event_stream(1))


def test_flatten_native_matches_numpy(full):
    cfg, _ = full
    rng = np.random.default_rng(5)
    E, B, P = 3, cfg.nblocks, cfg.maxwfpulses
    npulse = rng.integers(0, 4, (E, B)).astype(np.int32)
    times = rng.standard_normal((E, B, P))
    amps = rng.standard_normal((E, B, P))
    for x, y in zip(flatten_pulses(npulse, times, amps),
                    flatten_pulses_np(npulse, times, amps)):
        np.testing.assert_array_equal(x, y)


def test_native_build_failure_raises(full, monkeypatch, tmp_path):
    """Without g++ the native decoder raises when it is asked for; the
    numpy decode runs only on request."""
    cfg, cal = full
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    seg = build_segment(cfg, [np.concatenate([[3.0, 4.0], np.ones(4)])],
                        [_no_hits()], evt=np.ones(1), runnum=np.ones(1))
    with pytest.raises(RuntimeError, match="native decoder"):
        decode_segment(cfg, cal, seg, use_native=True)
    d = decode_segment(cfg, cal, seg, use_native=False)
    assert d.pres[0, 3] == 1 and d.signal[0, 3, :4].tolist() == [1.0] * 4


# ---------------------------------------------------------------------
# writer packets
# ---------------------------------------------------------------------
E = 4
_JAX_OUTS = {}


def _jax_output(small_cfg, small_cal, dtype):
    """One JAX PipelineOutput (one compile per dtype) on a small batch
    read out sparsely (the present lanes are those with pulses, plus every
    third absent lane), and the batch. Two pulse slots a block: one fit
    bucket keeps the JAX compile short; the packets take any P."""
    npt = np.float64 if dtype == torch.float64 else np.float32
    cfg = small_cfg.replace(compute_dtype=np.dtype(npt).name, maxwfpulses=2)
    truth = jax_make_events(cfg, small_cal, E, occupancy=0.4, max_pulses=2,
                            pileup_prob=0.9, seed=5)
    pres = (truth.npulse > 0) | (np.arange(E * cfg.nblocks).reshape(E, -1) % 3 == 0)
    sig = np.where(pres[..., None], truth.signal, 0.0).astype(npt)
    corr = np.random.default_rng(11).uniform(-2, 2, E).astype(npt)
    if dtype not in _JAX_OUTS:
        jcal = {k: jnp.asarray(v) for k, v in small_cal.device_arrays(cfg).items()}
        jb = jax_pipeline.EventBatch(
            signal=jnp.asarray(sig), pres=jnp.asarray(pres),
            corr_time_HMS=jnp.asarray(corr), evt=jnp.arange(E),
            runnum=jnp.zeros(E, jnp.int32))
        out = jax.jit(lambda b: jax_pipeline.process_batch(cfg, jcal, b))(jb)
        _JAX_OUTS[dtype] = (cfg, jax.device_get(out), sig, pres, corr)
    return _JAX_OUTS[dtype]


def _to_torch(out):
    return pipeline.PipelineOutput(*(torch.as_tensor(np.array(v)) for v in out))


DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["fp64", "fp32"])


def _same_packet(a, b):
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert x.dtype == y.dtype, f


@DTYPES
def test_dense_packet_bit_equal_to_jax(small_cfg, small_cal, dtype):
    """flatten_packet(pack_for_writer(out, cap)) of the same output equals
    the JAX buffer bit for bit (zero tail included), and both unflatten to
    the same packet."""
    cfg, out, *_ = _jax_output(small_cfg, small_cal, dtype)
    B = cfg.nblocks
    cap = 2 * E * B
    ref = np.asarray(jax.jit(lambda o: jax_pipeline.flatten_packet(
        jax_pipeline.pack_for_writer(o, cap)))(out))
    ours = pipeline.flatten_packet(pipeline.pack_for_writer(_to_torch(out), cap))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), ref.view(np.uint32))
    pkt, ovf = pipeline.unflatten_packet(ours.numpy(), E, B, cap)
    jpkt, jovf = jax_pipeline.unflatten_packet(ref, E, B, cap)
    assert not ovf and not jovf
    assert 0 < int(pkt.n_wf) < cap and int(pkt.n_h) > 0
    _same_packet(pkt, jpkt)


@DTYPES
def test_slab_packet_bit_equal_to_jax(small_cfg, small_cal, dtype):
    """flatten_packet_slab equals the JAX buffer bit for bit; both rebuild
    the same packet, whose ragged flats equal the dense packet's; an
    undersized lane_cap flags overflow."""
    cfg, out, _, pres, _ = _jax_output(small_cfg, small_cal, dtype)
    B, P = cfg.nblocks, cfg.maxwfpulses
    n_pres = int(pres.sum())
    assert 0 < n_pres < E * B
    tout = _to_torch(out)
    for lane_cap in (n_pres, max(1, n_pres // 2)):
        slab = jax.jit(jax_pipeline.flatten_packet_slab,
                       static_argnames=("lane_cap",))
        ref = np.asarray(slab(out, jnp.asarray(pres), lane_cap=lane_cap))
        ours = pipeline.flatten_packet_slab(tout, torch.as_tensor(pres), lane_cap)
        np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                      ref.view(np.uint32))
        pkt, ovf = pipeline.unflatten_packet(ours.numpy(), E, B, 0, pres=pres,
                                             lane_cap=lane_cap, P=P)
        jpkt, jovf = jax_pipeline.unflatten_packet(ref, E, B, 0, pres=pres,
                                                   lane_cap=lane_cap, P=P)
        assert ovf == jovf == (lane_cap < n_pres)
        if not ovf:
            _same_packet(pkt, jpkt)
            dense, _ = pipeline.unflatten_packet(
                pipeline.flatten_packet(pipeline.pack_for_writer(tout, 2 * E * B)
                                        ).numpy(), E, B, 2 * E * B)
            for f in ("wftime_flat", "wfampl_flat", "h1time_flat", "h2time_flat"):
                n = getattr(pkt, f).size
                np.testing.assert_array_equal(getattr(dense, f)[:n],
                                              getattr(pkt, f), err_msg=f)


def test_packets_write_the_dense_columns(small_cfg, small_cal, tmp_path):
    """At fp32 the dense packet, the slab packet and the dense output give
    the writer the same columns."""
    cfg, out, sig, pres, corr = _jax_output(small_cfg, small_cal, torch.float32)
    from npswf_tpu_torch.io.decode import DecodedBatch
    B = cfg.nblocks
    d = DecodedBatch(signal=sig, pres=pres.astype(np.uint8),
                     minsignal=sig.min(axis=2), bad_slot=np.full(E, -1, np.int32),
                     corr_time_HMS=corr.astype(np.float64),
                     sampampl=np.zeros((E, B)), samptime=np.zeros((E, B)),
                     sampener=np.zeros((E, B)), sampped=np.zeros((E, B)),
                     hcana_npulse=np.zeros((E, B)), evt=np.arange(E),
                     runnum=np.zeros(E))
    tout = _to_torch(out)
    cols = []
    dense, _ = pipeline.unflatten_packet(pipeline.flatten_packet(
        pipeline.pack_for_writer(tout, 2 * E * B)).numpy(), E, B, 2 * E * B)
    slab, _ = pipeline.unflatten_packet(pipeline.flatten_packet_slab(
        tout, torch.as_tensor(pres), E * B).numpy(), E, B, 0, pres=pres,
        lane_cap=E * B, P=cfg.maxwfpulses)
    for i, (add, arg) in enumerate((("add_batch", output_to_host(tout)),
                                    ("add_packet", dense), ("add_packet", slab))):
        w = WFWriter(NPSConfig.from_json(cfg.to_json()))
        getattr(w, add)(arg, d, n_valid=E - 1)
        cols.append(w.finalize(str(tmp_path / f"{i}.npz"), compress=False))
    assert cols[0]["wf_offsets"][-1] > 0 and cols[0]["h_offsets"][-1] > 0
    for other in cols[1:]:
        assert cols[0].keys() == other.keys()
        for k in cols[0]:
            np.testing.assert_array_equal(cols[0][k], other[k], err_msg=k)


_PORT = {}


def _port_batches(small_cfg, small_cal, k=2):
    """k small port batches (fp32, P = 2; the second read out where it has
    pulses) and their process_batch outputs, made once."""
    if not _PORT:
        cfg = NPSConfig.from_json(small_cfg.to_json()).replace(maxwfpulses=2)
        calib = calib_to_torch(small_cal.device_arrays(cfg), "cpu", torch.float32)
        batches = []
        for i in range(k):
            truth = make_events(cfg, small_cal, E, occupancy=0.4, max_pulses=2,
                                pileup_prob=0.5, seed=20 + i)
            pres = (truth.npulse > 0) | (i == 0)
            batches.append(batch_to_torch(truth.signal.astype(np.float32), pres,
                                          np.full(E, 0.5 * i), "cpu",
                                          torch.float32))
        outs = [pipeline.process_batch(cfg, calib, b) for b in batches]
        _PORT.update(cfg=cfg, calib=calib, batches=batches, outs=outs)
    return _PORT["cfg"], _PORT["calib"], _PORT["batches"], _PORT["outs"]


@pytest.mark.parametrize("slab", [False, True], ids=["dense", "slab"])
def test_packed_chain_equals_single_calls(small_cfg, small_cal, slab):
    """make_pipeline_packed_chain over k = 2 batches equals the packets of
    two single process_batch calls bit for bit."""
    cfg, calib, batches, outs = _port_batches(small_cfg, small_cal)
    B = cfg.nblocks
    cap, lane_cap = 2 * E * B, (E * B if slab else 0)
    chained = pipeline.make_pipeline_packed_chain(cfg, calib, cap, lane_cap)(batches)
    assert chained.shape[0] == 2
    for i, (b, out) in enumerate(zip(batches, outs)):
        one = (pipeline.flatten_packet_slab(out, b.pres, lane_cap) if slab
               else pipeline.flatten_packet(pipeline.pack_for_writer(out, cap)))
        assert torch.equal(chained[i], one)

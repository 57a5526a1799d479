"""The port's mesh (npswf_tpu_torch/parallel) on the CPU, against the JAX
package's.

Ranks are gloo processes on the CPU started by ``parallel.mesh.launch``
(spawn, one thread a rank, a file rendezvous under the test's tmp_path, so
concurrent test workers never share a port). Their bodies live in the port
package, so the children import no jax. The batch is tests/test_parallel.py's
(E = 8, occupancy 0.05, seed 23) at fp64, where the port's sharded outputs
are bit-equal to its single-device ones and its decisions equal the JAX
package's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npswf_tpu.engine.pipeline import EventBatch as JaxEventBatch
from npswf_tpu.ops.cluster_gate import cluster_sums as jax_cluster_sums
from npswf_tpu.parallel.mesh import (make_mesh as jax_make_mesh,
                                     make_sharded_pipeline as jax_sharded,
                                     shard_calibration as jax_shard_calibration,
                                     shard_event_batch as jax_shard_event_batch)
from npswf_tpu.utils.synthetic import make_events
from npswf_tpu_torch.core.calibration import (CalibrationBundle,
                                              synthetic_calibration)
from npswf_tpu_torch.core.config import NPSConfig as TorchConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.engine.pipeline import PipelineOutput, process_batch
from npswf_tpu_torch.io.rawstream import build_segment
from npswf_tpu_torch.io.writer import WF_COLUMNS, read_wf
from npswf_tpu_torch.parallel.dryrun import (dryrun, dryrun_batch,
                                             mesh_shapes, unequal_fields)
from npswf_tpu_torch.parallel.mesh import (make_mesh, sharded_cluster_sums,
                                           sharded_process_batch)
from npswf_tpu_torch.runtime.executor import run_segment

E = 8
DECISIONS = ("wfnpulse", "gate", "fit_converged")
COUNTERS = ("n_fit_success", "n_fit_failure", "n_fit_dropped", "n_high_pulse",
            "n_search_dropped")


def _port(cfg):
    return TorchConfig.from_json(cfg.to_json())


def _cpu_mesh(cfg, n_data, n_block):
    return make_mesh(_port(cfg), n_data, n_block,
                     devices=["cpu"] * (n_data * n_block))


@pytest.fixture(scope="module")
def f64(cfg):
    return cfg.replace(compute_dtype="float64")


@pytest.fixture(scope="module")
def batch(f64, cal):
    """tests/test_parallel.py's batch, as numpy arrays."""
    truth = make_events(f64, cal, E, occupancy=0.05, max_pulses=2, seed=23)
    corr = np.random.default_rng(23).uniform(-2, 2, E)
    return truth.signal, truth.pres.astype(bool), corr


@pytest.fixture(scope="module")
def single(f64, cal, batch):
    """The port's single-device output (host arrays)."""
    sig, pres, corr = batch
    out = process_batch(_port(f64), calib_to_torch(cal.device_arrays(f64),
                                                   "cpu", torch.float64),
                        batch_to_torch(sig, pres, corr, "cpu", torch.float64))
    return PipelineOutput(*(t.numpy() for t in out))


@pytest.fixture(scope="module")
def sharded(f64, cal, batch, tmp_path_factory):
    """The port's outputs over CPU meshes (2, 2) and (4, 1), each a launch
    of its own, started together in the background so that the ranks run
    while the JAX package compiles its sharded pipelines."""
    from concurrent.futures import ThreadPoolExecutor
    sig, pres, corr = batch
    host = batch_to_torch(sig, pres, corr, "cpu", torch.float64)
    work = str(tmp_path_factory.mktemp("ranks"))
    pool = ThreadPoolExecutor(max_workers=2)
    runs = {shape: pool.submit(sharded_process_batch, _cpu_mesh(f64, *shape),
                               _port(f64), cal.device_arrays(f64), host,
                               workdir=work)
            for shape in ((2, 2), (4, 1))}
    yield runs
    pool.shutdown(wait=True)


def _jax_sharded(f64, cal, batch, shape):
    """The JAX package's sharded pipeline on a mesh of ``shape`` (host
    arrays)."""
    sig, pres, corr = batch
    calib = {k: jnp.asarray(v) for k, v in cal.device_arrays(f64).items()}
    jb = JaxEventBatch(signal=jnp.asarray(sig), pres=jnp.asarray(pres),
                       corr_time_HMS=jnp.asarray(corr),
                       evt=jnp.arange(E, dtype=jnp.float64),
                       runnum=jnp.full(E, 3000.0))
    mesh = jax_make_mesh(f64, n_data=shape[0], n_block=shape[1])
    ref = jax_sharded(f64, jax_shard_calibration(f64, calib, mesh), mesh)(
        jax_shard_event_batch(f64, jb, mesh))
    return {f: np.asarray(getattr(ref, f)) for f in ref._fields}


@pytest.fixture(scope="module")
def jax_refs(f64, cal, batch):
    """The JAX package's sharded outputs at (2, 2) and (4, 1), compiled
    together in two threads (the compiles release the interpreter)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        runs = {sh: pool.submit(_jax_sharded, f64, cal, batch, sh)
                for sh in ((2, 2), (4, 1))}
        return {sh: run.result() for sh, run in runs.items()}


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_sharded_process_batch_matches_jax_mesh(single, sharded, jax_refs,
                                                shape):
    """The port's sharded process_batch against the JAX package's sharded
    pipeline on the same mesh shape: decisions and the counters exact,
    values within tests/test_parallel.py's tolerances; and against the
    port's single device, every field equal, value for value."""
    ref = jax_refs[shape]
    out, counts = sharded[shape].result()
    for name in DECISIONS:
        np.testing.assert_array_equal(getattr(out, name), ref[name], name)
    for name in COUNTERS:
        assert int(getattr(out, name)) == int(ref[name]), name
    for name in ("chi2", "wftime"):
        np.testing.assert_allclose(getattr(out, name), ref[name], rtol=2e-6,
                                   atol=2e-6, err_msg=name)
    np.testing.assert_allclose(out.enertot, ref["enertot"], rtol=2e-6)
    assert unequal_fields(out, single) == []
    assert len(counts) == shape[0] * shape[1]
    assert all(c["plain_calls"].get("lm_solve") for c in counts)


def test_cluster_sums_across_four_block_shards(cfg, tmp_path):
    """The halo exchange: cluster sums over 4 row shards equal the JAX
    package's halo-exchanged sums of tests/test_parallel.py (a 2 x 4 mesh)
    and its single-device stencil."""
    from jax.sharding import PartitionSpec as P

    from npswf_tpu.parallel.mesh import shard_map
    sig = np.random.default_rng(3).standard_normal((2, cfg.nblocks, cfg.ntime))
    ours = sharded_cluster_sums(_cpu_mesh(cfg, 1, 4), _port(cfg), sig,
                                workdir=str(tmp_path))
    mesh = jax_make_mesh(cfg, n_data=2, n_block=4)

    def body(x):
        return jax_cluster_sums(cfg, x, block_axis=cfg.mesh_block_axis,
                                block_shards=4)
    ref = jax.jit(shard_map(body, mesh, in_specs=(P("data", "block", None),),
                            out_specs=P("data", "block", None)))(
        jnp.asarray(sig))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-12)
    np.testing.assert_allclose(ours, np.asarray(jax_cluster_sums(
        cfg, jnp.asarray(sig))), rtol=1e-12)


@pytest.fixture(scope="module")
def segment_files(f64, cal, tmp_path_factory):
    """A segment through run_segment on one device and under a (2, 2) CPU
    mesh (batches of 4): 4 events and the same 4 again, so that the mesh's
    launch runs the same inputs twice. Returns the two WF files' paths."""
    from npswf_tpu_torch.tools.cli import synth_records
    from npswf_tpu_torch.utils.synthetic import make_events as port_events
    tmp = tmp_path_factory.mktemp("segment")
    cfg = _port(f64)
    pcal = CalibrationBundle.load(_save(cal, tmp))
    truth = port_events(cfg, pcal, 4, occupancy=0.05, max_pulses=2, seed=5)
    streams, hits = synth_records(cfg, truth, np.random.default_rng(6))
    seg = build_segment(cfg, streams * 2, hits * 2, evt=np.arange(8.0),
                        runnum=np.full(8, 3000.0))
    one, two = str(tmp / "one.npz"), str(tmp / "mesh.npz")
    r1 = run_segment(cfg, pcal, seg, one, batch_size=4, device="cpu")
    r2 = run_segment(cfg, pcal, seg, two, batch_size=4,
                     mesh=_cpu_mesh(f64, 2, 2))
    assert r1.n_fit_success == r2.n_fit_success > 0
    return one, two


def test_same_inputs_same_mesh_bitwise_identical(segment_files):
    """The same 4 events run twice on the same (2, 2) mesh (the segment's
    first two batches) give the same rows, bit for bit (the reference's
    race-avoidance discipline as a determinism guarantee)."""
    wf = read_wf(segment_files[1])
    assert wf["wf_offsets"][4] > 0
    for name in WF_COLUMNS:     # the per-event columns
        col = wf[name]
        if name.endswith("_flat"):
            offs = wf[("h" if name.startswith("h") else "wf") + "_offsets"]
            np.testing.assert_array_equal(col[offs[0]:offs[4]],
                                          col[offs[4]:offs[8]], name)
        elif name != "evt":
            np.testing.assert_array_equal(col[:4], col[4:8], name)


def test_run_segment_on_a_mesh_writes_the_single_device_file(segment_files):
    """run_segment under a (2, 2) CPU mesh writes the same WF file, byte
    for byte, as on one device (dense packet, batch-granular parts merged
    by rank 0)."""
    one, two = segment_files
    with open(one, "rb") as a, open(two, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(two + ".parts")


def test_dryrun_on_two_cpu_ranks():
    """The mesh's dry run on two gloo ranks of the CPU, on a 6 x 5 grid:
    its batch engages the retries and the mid bucket, and the 2 x 1 and
    1 x 2 meshes equal one device in every field."""
    cfg = TorchConfig(compute_dtype="float32", nlin=6, ncol=5)
    cal = synthetic_calibration(cfg, seed=1)
    meshes = [("gloo", nd, nb) for nd, nb in mesh_shapes(cfg, 2)]
    rep = dryrun(cfg, cal, dryrun_batch(cfg, cal, 8), meshes, ["cpu"] * 2,
                 engaged=True)
    assert rep["fit_failures"] > 0 and rep["mid_bucket_lanes"] > 0
    assert {k: m["unequal"] for k, m in rep["meshes"].items()} == {
        "gloo 2x1": [], "gloo 1x2": []}


def _save(cal, tmp_path):
    path = str(tmp_path / "cal.npz")
    cal.save(path)
    return path


def test_make_mesh_checks(cfg):
    """Too few devices, a block count that does not divide the rows, and
    NCCL with a card named twice are refused; ranks are data-major."""
    port = _port(cfg)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(port, 2, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="must divide nlin"):
        make_mesh(port, 1, 5, devices=["cpu"] * 5)
    with pytest.raises(ValueError, match="names one twice"):
        make_mesh(port, 2, 1, devices=["cuda:0", "cuda:0"], backend="nccl")
    mesh = make_mesh(port, 2, 3, devices=["cpu"] * 8)
    assert mesh.size == 6 and mesh.backend == "gloo"
    assert mesh.shape == {"data": 2, "block": 3}
    assert mesh_shapes(port, 4) == [(4, 1), (1, 4), (2, 2)]

"""The port's copies of the JAX package's host code pinned to the originals.

The port imports nothing of the JAX package, so the host code it shares is
copied: ``core.config``, ``core.calibration``, ``utils.synthetic``, the
host I/O (``io.rawstream``, ``io.decode``, ``io.writer``, ``io.merge``, the
C++ decoder ``io/native/decode.cpp``), the scalar oracles
(``golden.reference``, ``golden.searchhighres_decimal``), the host tools
(``parity``, ``diagnostics``, ``cpu_baseline``, ``convert_root``,
``convert_wf_to_root``, ``extract_templates``, ``derive_fixtures``,
``plotstats``), ``StageTimer``, the host inverses of the writer packets and
the probes' host helpers (``e2e_bench.build_tiled_segment``,
``glue_profile._patched``). Same fields and defaults, same arrays from
the same seeds, and every copied function and method identical in source
up to the package's name.

Ported, not copied (``PORTED`` says why for each): the executor's device
side, the CLI's commands, ``device_trace``, the solver audit's device side
and ``cpu_baseline.main``. The native loader
(``io/native/__init__.py``) is a port as a whole: it builds into the
port's build directory under a lock and raises where the original falls
back to numpy.
"""
import dataclasses
import inspect
import io
import pathlib
import textwrap
import tokenize

import numpy as np
import pytest

import npswf_tpu.core.calibration as jax_calibration
import npswf_tpu.core.config as jax_config
import npswf_tpu.engine.pipeline as jax_pipeline
import npswf_tpu.golden.reference as jax_reference
import npswf_tpu.golden.searchhighres_decimal as jax_decimal
import npswf_tpu.io.decode as jax_decode
import npswf_tpu.io.merge as jax_merge
import npswf_tpu.io.rawstream as jax_rawstream
import npswf_tpu.io.writer as jax_writer
import npswf_tpu.runtime.executor as jax_executor
import npswf_tpu.tools.cli as jax_cli
import npswf_tpu.tools.convert_root as jax_convert_root
import npswf_tpu.tools.convert_wf_to_root as jax_convert_wf_to_root
import npswf_tpu.tools.cpu_baseline as jax_cpu_baseline
import npswf_tpu.tools.derive_fixtures as jax_derive_fixtures
import npswf_tpu.tools.diagnostics as jax_diagnostics
import npswf_tpu.tools.e2e_bench as jax_e2e_bench
import npswf_tpu.tools.extract_templates as jax_extract_templates
import npswf_tpu.tools.glue_profile as jax_glue_profile
import npswf_tpu.tools.measure_link as jax_measure_link
import npswf_tpu.tools.perf_probe as jax_perf_probe
import npswf_tpu.tools.parity as jax_parity
import npswf_tpu.tools.plotstats as jax_plotstats
import npswf_tpu.tools.solver_audit as jax_solver_audit
import npswf_tpu.utils.synthetic as jax_synthetic
import npswf_tpu.utils.timers as jax_timers
import npswf_tpu_torch.core.calibration as calibration
import npswf_tpu_torch.core.config as config
import npswf_tpu_torch.engine.pipeline as pipeline
import npswf_tpu_torch.golden.reference as reference
import npswf_tpu_torch.golden.searchhighres_decimal as decimal_oracle
import npswf_tpu_torch.io.decode as decode
import npswf_tpu_torch.io.merge as merge
import npswf_tpu_torch.io.rawstream as rawstream
import npswf_tpu_torch.io.writer as writer
import npswf_tpu_torch.runtime.executor as executor
import npswf_tpu_torch.tools.cli as cli
import npswf_tpu_torch.tools.convert_root as convert_root
import npswf_tpu_torch.tools.convert_wf_to_root as convert_wf_to_root
import npswf_tpu_torch.tools.cpu_baseline as cpu_baseline
import npswf_tpu_torch.tools.derive_fixtures as derive_fixtures
import npswf_tpu_torch.tools.diagnostics as diagnostics
import npswf_tpu_torch.tools.e2e_bench as e2e_bench
import npswf_tpu_torch.tools.extract_templates as extract_templates
import npswf_tpu_torch.tools.glue_profile as glue_profile
import npswf_tpu_torch.tools.measure_link as measure_link
import npswf_tpu_torch.tools.perf_probe as perf_probe
import npswf_tpu_torch.tools.parity as parity
import npswf_tpu_torch.tools.plotstats as plotstats
import npswf_tpu_torch.tools.solver_audit as solver_audit
import npswf_tpu_torch.utils.synthetic as synthetic
import npswf_tpu_torch.utils.timers as timers

PAIRS = [(config, jax_config), (calibration, jax_calibration),
         (synthetic, jax_synthetic), (rawstream, jax_rawstream),
         (decode, jax_decode), (writer, jax_writer), (merge, jax_merge),
         (reference, jax_reference), (plotstats, jax_plotstats),
         (timers, jax_timers), (executor, jax_executor), (cli, jax_cli),
         (decimal_oracle, jax_decimal), (parity, jax_parity),
         (diagnostics, jax_diagnostics), (cpu_baseline, jax_cpu_baseline),
         (convert_root, jax_convert_root),
         (convert_wf_to_root, jax_convert_wf_to_root),
         (extract_templates, jax_extract_templates),
         (derive_fixtures, jax_derive_fixtures),
         (solver_audit, jax_solver_audit), (e2e_bench, jax_e2e_bench),
         (glue_profile, jax_glue_profile), (perf_probe, jax_perf_probe),
         (measure_link, jax_measure_link)]

# definitions of those modules that are ported, not copied, and why
PORTED = {
    "timers.device_trace": "torch.profiler (a Chrome trace) in place of "
                           "jax.profiler",
    "executor.resolve_device": "the card unless the CPU is asked for",
    "executor.torch_dtype": "the compute dtype as a torch dtype",
    "executor._to_event_batch": "torch tensors on a device",
    "executor._to_device": "pinned memory and asynchronous copies",
    "executor._upload_signal": "torch upload: only the present rows, no "
                               "dropped padding rows",
    "executor._upload_batch": "torch upload, unpacked on the device",
    "executor._pow2": "the port has no jit cache for the bucketing to "
                      "bound",
    "executor.packet_caps": "the batch-0 sizing as a function, shared with "
                            "chip_smoke.py",
    "executor.output_to_host": "the dense fallback hands the writer host "
                               "arrays",
    "executor._Streams": "a CUDA stream per stage worker",
    "executor._on": "a CUDA stream per stage worker",
    "executor.run_segment": "streams, events and pinned copies in place of "
                            "JAX's asynchronous dispatch; a device argument; "
                            "the mesh path in _run_segment_mesh",
    "executor._warn_bad_events": "the reference's per-event warnings, "
                                 "shared by both paths",
    "executor._run_segment_mesh": "ranks on torch.distributed in place of "
                                  "shard_map",
    "executor._mesh_rank": "one rank of the mesh path: decode, shard, "
                           "gather on rank 0, which writes",
    "cli._device": "the CUDA device unless --cpu",
    "cli.cmd_run": "the device check, --config, the mesh from "
                   "parallel.mesh (gloo ranks with --cpu)",
    "cli._with_config_file": "run's --config (model_aux from a JSON file)",
    "cli._make_delegate": "every tool's main takes its arguments (the port's "
                          "cpu_baseline too)",
    "cli.synth_records": "synth's streams and hits, shared with chip_smoke.py",
    "cli.cmd_synth": "no JAX set-up; its records come from synth_records",
    "cli.build_parser": "the port's help",
    "cli.cmd_diagnostics": "no JAX set-up; a clear exit without matplotlib",
    "cpu_baseline.main": "takes the time budget and the block minimum",
    "solver_audit._host": "device tensors to numpy",
    "solver_audit.build_fit_inputs": "the pre-fit stages in torch on a device",
    "solver_audit.audit_signal": "a device argument; the pipeline's model "
                                 "(the planes, on K3)",
    "solver_audit.main": "--cpu picks the device; no JAX set-up",
    "e2e_bench.measure_device_only": "process_batch timed by CUDA events",
    "e2e_bench.run_mode": "a device argument; unrounded numbers",
    "e2e_bench.main": "--cpu picks the device",
    "glue_profile.main": "torch stubs; the slope over back-to-back batches "
                         "in place of a lax.scan",
    "glue_profile.batch_slope": "the per-batch slope timed by CUDA events",
    "perf_probe._chi2": "a torch fetch",
    "measure_link.dense_batch_bytes": "the port's own dense payload",
    "perf_probe._setup": "torch tensors on the card or the CPU",
    "perf_probe._pipelined": "torch: a fetch is a copy to the host",
    "perf_probe.cmd_floor": "the executor's packet chains",
    "perf_probe.cmd_esweep": "torch; --sizes",
    "perf_probe.cmd_chain": "the executor's packet chains; --sizes",
    "perf_probe.main": "--cpu, --sizes and a JSON line",
    "measure_link._timed_transfers": "pinned torch buffers and copies",
    "measure_link.measure_link": "GB/s; the port's own dense payload; no "
                                 "TPU constant",
    "measure_link.main": "--cpu; no default device time",
}


def _copied(module):
    """(qualified name, object) of each function, class and class member
    the copy defines in its source (a class may leave out members of its
    original; the methods a dataclass generates have no source)."""
    def written(fn):
        fn = inspect.unwrap(fn) if callable(fn) else fn
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


def _short(module, name):
    return f"{module.__name__.split('.')[-1]}.{name.split('.')[0]}"


COPIED = [(ours, ref, name) for ours, ref in PAIRS for name, _ in _copied(ours)
          if _short(ours, name) not in PORTED]
# the host inverses of the writer packets, in a module that is otherwise a
# port
COPIED += [(pipeline, jax_pipeline, n)
           for n in ("unflatten_packet", "unflatten_packet_slab")]


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
    """Each function and method of a copy is its original, token for token
    (comments and indentation included), up to the package's name: the
    longer name may move the continuation lines of an import."""
    def tokens(obj):
        src = textwrap.dedent(inspect.getsource(_lookup(obj, name)))
        src = src.replace("npswf_tpu_torch", "npswf_tpu")
        return [(t.type, t.string) for t in
                tokenize.generate_tokens(io.StringIO(src).readline)
                if t.type != tokenize.NL]
    assert tokens(ours) == tokens(ref)


def test_ported_definitions_exist():
    """Every name PORTED excuses is defined in the port (none is stale)."""
    defined = {_short(ours, name) for ours, _ in PAIRS
               for name, _ in _copied(ours)}
    assert set(PORTED) <= defined


def test_native_decoder_source_is_the_original():
    """io/native/decode.cpp is the original under one line naming it."""
    ours = pathlib.Path(decode.__file__).parent / "native" / "decode.cpp"
    ref = pathlib.Path(jax_decode.__file__).parent / "native" / "decode.cpp"
    first, rest = ours.read_text().split("\n", 1)
    assert "npswf_tpu/io/native/decode.cpp" in first
    assert rest == ref.read_text()

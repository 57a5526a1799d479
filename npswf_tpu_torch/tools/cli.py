"""Command-line entry point of the PyTorch/CUDA port.

Ported from npswf_tpu/tools/cli.py. It mirrors the reference entry point
``TEST_2(run, seg, threads[, diagnostics])`` (ref TEST_2.C:281-286,
README.md:22-34):

    python -m npswf_tpu_torch.tools.cli run --run 3000 --seg 0 \\
        --input nps_segment.npz --calib cal.npz --out out_wf.npz

Subcommands:
    run             process a raw segment into a WF output file
    synth           generate a synthetic raw segment + calibration (testing)
    validate        plotstats-equivalent output-integrity check

``run`` uses the CUDA device unless ``--cpu`` is given; without a card it
exits non-zero. ``--x64`` is accepted and does nothing: the compute dtype
is the configuration's ``compute_dtype``. More than one device
(``--devices``, ``--block-shards``) is not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def _device(args) -> str:
    return "cpu" if getattr(args, "cpu", False) else "cuda"


def _load_calibration(cfg, args):
    from npswf_tpu_torch.core.calibration import (CalibrationBundle,
                                                  EpochManifest,
                                                  load_calibration,
                                                  synthetic_calibration)
    if args.calib and args.calib.endswith(".npz"):
        return CalibrationBundle.load(args.calib)
    if args.calib:  # manifest root dir or manifest.json
        if args.calib.endswith(".json"):
            manifest = EpochManifest.load(args.calib)
        else:
            manifest = EpochManifest(root=args.calib)
        return load_calibration(cfg, manifest, args.run)
    logging.warning("no --calib given; using synthetic calibration")
    return synthetic_calibration(cfg, run=args.run)


def cmd_run(args) -> int:
    import torch
    from npswf_tpu_torch.core.config import config_for_run
    from npswf_tpu_torch.io.rawstream import read_segment
    from npswf_tpu_torch.runtime.executor import run_segment

    if args.devices > 1 or args.block_shards > 1:
        raise NotImplementedError(
            "--devices/--block-shards: the torch.distributed mesh is ROADMAP "
            "Queue 1 item 11")
    device = _device(args)
    if device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 3
    # seg-derived default file names, mirroring the reference's
    # nps_hms_coin_{run}_{seg}... -> nps_production_{run}_{seg}_{threads}...
    # pattern (ref TEST_2.C:290, 301)
    if args.input is None:
        args.input = f"nps_segment_{args.run}_{args.seg}.npz"
    if args.out is None:
        args.out = f"nps_production_{args.run}_{args.seg}_{args.devices}_wf.npz"
    if not os.path.exists(args.input):
        print(f"ERROR: Cannot open file: {args.input}", file=sys.stderr)
        return 2

    cfg = config_for_run(args.run)
    if args.fit_capacity:
        cfg = cfg.replace(fit_capacity=args.fit_capacity)
    if args.search_capacity:
        cfg = cfg.replace(search_capacity=args.search_capacity)
    if args.model:
        cfg = cfg.replace(model_name=args.model)
    cal = _load_calibration(cfg, args)
    seg = read_segment(args.input)
    if args.range:
        lo, hi = args.range
        seg = seg.slice(lo, min(hi, seg.n_events))
    res = run_segment(cfg, cal, seg, args.out, batch_size=args.batch_size,
                      resume=not args.no_resume,
                      use_native_decode=not args.no_native,
                      profile_dir=args.profile,
                      chain_batches=args.chain_batches, device=device)
    print(f"processed {res.n_events} events in {res.wall_time:.2f}s "
          f"({res.events_per_sec:.1f} ev/s, {res.blocks_per_sec:.0f} blocks/s)")
    print(f"Total failed fits: {res.n_fit_failure} "
          f"total fits succeed: {res.n_fit_success}")
    return 0


def synth_records(cfg, truth, rng, pres=None):
    """Raw streams and hcana hit arrays of synthetic events (as ``synth``
    writes them); ``pres`` [E, B] selects the blocks read out (default:
    the truth's, every block)."""
    from npswf_tpu_torch.io.rawstream import encode_event_stream
    pres = truth.pres.astype(bool) if pres is None else pres
    streams, hits = [], []
    for e in range(truth.signal.shape[0]):
        streams.append(encode_event_stream(cfg, truth.signal[e], pres[e]))
        nb = np.nonzero(truth.npulse[e])[0]
        hits.append({
            "adc_counter": nb.astype(np.float64),
            "pulse_time": truth.times[e, nb, 0] * cfg.dt +
            rng.standard_normal(nb.size) * 0.1,
            "pulse_time_raw": rng.uniform(0, 4000, nb.size),
            "pulse_amp": truth.amps[e, nb, 0],
            "pulse_int": truth.amps[e, nb, 0] * 7.5,
            "pulse_ped": truth.pedestal[e, nb]})
    return streams, hits


def cmd_synth(args) -> int:
    from npswf_tpu_torch.core.config import config_for_run
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.utils.synthetic import make_events
    from npswf_tpu_torch.io.rawstream import build_segment, write_segment

    cfg = config_for_run(args.run)
    cal = synthetic_calibration(cfg, run=args.run, seed=args.seed)
    truth = make_events(cfg, cal, args.events, occupancy=args.occupancy,
                        max_pulses=args.max_pulses, seed=args.seed)
    rng = np.random.default_rng(args.seed + 1)
    streams, hits = synth_records(cfg, truth, rng)
    seg = build_segment(cfg, streams, hits,
                        evt=np.arange(args.first_evt, args.first_evt + args.events,
                                      dtype=np.float64),
                        runnum=np.full(args.events, args.run, np.float64))
    write_segment(args.out, seg)
    if args.calib_out:
        cal.save(args.calib_out)
    print(f"wrote {args.events} synthetic events to {args.out}"
          + (f" and calibration to {args.calib_out}" if args.calib_out else ""))
    return 0


def cmd_validate(args) -> int:
    from npswf_tpu_torch.tools.plotstats import main as plotstats_main
    return plotstats_main([args.wf_file] + (["--verbose"] if args.verbose else []))


_X64_HELP = ("accepted and ignored: the compute dtype is the configuration's "
             "compute_dtype")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="npswf-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="process a raw segment")
    p.add_argument("--run", type=int, default=3000)
    p.add_argument("--seg", type=int, default=0,
                   help="segment number; names the default --input/--out "
                        "(the reference's file-name pattern, TEST_2.C:290, 301)")
    p.add_argument("--input", default=None,
                   help="raw segment .npz (default: nps_segment_{run}_{seg}.npz)")
    p.add_argument("--calib", default=None,
                   help=".npz bundle, manifest .json, or calibration root dir")
    p.add_argument("--out", default=None,
                   help="WF output .npz (default: "
                        "nps_production_{run}_{seg}_{devices}_wf.npz)")
    p.add_argument("--model", default=None,
                   help="waveform model family (default spline_ref)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--chain-batches", type=int, default=1,
                   help="batches a call, fetched as one stacked packet")
    p.add_argument("--devices", type=int, default=1,
                   help="only 1: more devices are not ported yet")
    p.add_argument("--block-shards", type=int, default=1,
                   help="only 1: block-row sharding is not ported yet")
    p.add_argument("--fit-capacity", type=int, default=0)
    p.add_argument("--search-capacity", type=int, default=0,
                   help="max searched lanes per batch (sparse-readout "
                        "compaction); present lanes beyond it are counted "
                        "in n_search_dropped, never silently dropped")
    p.add_argument("--range", type=int, nargs=2, metavar=("LO", "HI"),
                   help="process only events [LO, HI) of the segment "
                        "(the reference's df.Range subset mode)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--no-native", action="store_true",
                   help="decode with numpy instead of the C++ decoder")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace to this directory")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--x64", action="store_true", help=_X64_HELP)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("synth", help="generate synthetic segment + calibration")
    p.add_argument("--events", type=int, default=64)
    p.add_argument("--run", type=int, default=3000)
    p.add_argument("--occupancy", type=float, default=0.05)
    p.add_argument("--max-pulses", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--first-evt", type=int, default=1)
    p.add_argument("--out", required=True)
    p.add_argument("--calib-out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="accepted and ignored: synth runs on the host")
    p.add_argument("--x64", action="store_true", help=_X64_HELP)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("validate", help="output-integrity check (plotstats)")
    p.add_argument("wf_file")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_validate)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

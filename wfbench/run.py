"""Run one cell of the port's benchmark and print its result line.

    python3 wfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json and the cell's files (configuration, traffic mix,
per-layer readers, limits), then needs the card: without a CUDA device, or
with fewer than the cell asks for, it exits 2 and prints no result. It makes
the calibration and the traffic from ``--seed``, builds or loads the
program's kernels (``build/npswf_tpu_torch/`` in the checkout), warms up
the cell's shapes, measures for ``--seconds``, checks the answers against
the plain reference, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and the trace's breakdown (a traced run's window is one
pass over the segment or one call a pool batch, whatever ``--seconds``
says, and the traced slice follows it). The numbers compared, each
beside its limit, end standard error and the line (``checks``). If JAX or
the JAX package was loaded it exits 3 and prints no result.
"""
import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="wfbench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True,
                    help="a workload name of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True,
                    help="makes the calibration, the traffic and the sample "
                         "of answers compared")
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: per-layer metrics from a traced slice after a "
                         "window of one pass or one call a pool batch")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from wfbench import harness, spec
    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as exc:
        print(f"wfbench: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("wfbench: no CUDA device: the benchmark measures the card and "
              "does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"wfbench: {cell.name} needs {cell.chips} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"wfbench: the run loaded {', '.join(found)}; the port's "
              f"benchmark may not", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

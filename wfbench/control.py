"""The readings that a cell's limits are set from: the program on a dozen
seeds and the control on a few, each through a short window at the cell's
own load and the same comparison a run makes.

    python3 wfbench/control.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--seconds 3] [--out FILE]

The control is the nearest precision below the configuration's: for a
float64 configuration the program's own float32 path; for float32, which
the program has no path below, the plain reference computed in bfloat16,
put in the program's place. Each reading is one JSON line; the last line
holds, per number, the largest program reading (the lower) and the
smallest control reading (the upper). The benchmark's runs do not run
this. It needs the card, as a run does.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROL = {"float64": ("program", "float32"),
           "float32": ("reference", "bfloat16")}


def readings(cell, seed: int, side: str, seconds: float, dev,
             workers=None) -> dict:
    """One seed's numbers, of the program (side "program") or of the
    control (side "control")."""
    from wfbench import compare, generate, harness
    g = cell.geometry
    t = cell.traffic
    dtype = cell.dtype_name
    data = generate.make_traffic(cell.fields, t, seed, workers=workers)
    kind, low = CONTROL[dtype] if side == "control" else ("program", dtype)
    if t["entry"] == "run_segment":
        E = t["batch_size"]
        picked = harness.sample(seed, -(-t["events"] // E), t["check_batches"])
        if kind == "program":
            entry = harness.SegmentEntry(dict(cell.fields, compute_dtype=low),
                                         data, t, dev,
                                         tempfile.gettempdir())
            entry.warm_up()
            entry.window(seconds)
            wf = entry.wf_file()
            entry.close()
            harness.free_device()
            return harness.check_segment(g, data, wf, picked, E, dtype,
                                         dev)[0]
        rows = []
        for b in picked:
            lo, hi = b * E, min(t["events"], (b + 1) * E)
            _, want = harness.reference_segment_batch(g, data, lo, hi, dtype,
                                                      dev)
            _, got = harness.reference_segment_batch(g, data, lo, hi, low, dev)
            r = compare.compare(compare.wf_view(got), want, g.dt)
            r["columns_unequal"] = 0.0    # the control decodes as the reference
            rows.append(r)
        nums = compare.merge(rows)
        nums["events_unequal"] = 0.0     # its rows are the segment's events
        return nums
    picked = harness.sample(seed, t["pool"], t["check_calls"])
    if kind == "program":
        entry = harness.BatchEntry(cell.fields, data, dev, low)
        entry.warm_up()
        entry.window(seconds)
        answers = entry.answers(picked)
        del entry
        harness.free_device()
    else:
        answers = {i: harness.reference_batch(g, data, i, low, dev)
                   for i in picked}
    return harness.check_batches(g, data, answers, dtype, dev)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    from wfbench import spec
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from npswf_tpu_torch import kernels
    kernels.library()
    lines = []
    runs = [("program", int(s)) for s in args.seeds.split(",") if s]
    runs += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for side, seed in runs:
        t0 = time.perf_counter()
        nums = readings(cell, seed, side, args.seconds, dev)
        line = {"cell": cell.name, "side": side, "seed": seed,
                "numbers": nums, "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"cell": cell.name, "lower": {}, "upper": {}}
    for side, key, pick in (("program", "lower", max), ("control", "upper", min)):
        vals = [ln["numbers"] for ln in lines if ln["side"] == side]
        if vals:
            summary[key] = {k: pick(v[k] for v in vals) for k in vals[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

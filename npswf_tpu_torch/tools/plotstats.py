# Copied from npswf_tpu/tools/plotstats.py; tests/test_torch_host.py pins it there.
"""Output-integrity validator — the plotstats.C equivalent.

Replays the WF output through its stored (runnum, evt) index and asserts the
sorted global event numbers are contiguous (ref plotstats.C:31-46), which
validates the shuffled-batch + ordered-merge path exactly as the reference's
check validates the MT shuffle + BuildIndex re-sort.

Accepts the WF .npz, or a bridged ROOT WF tree (needs uproot).

Usage: python -m npswf_tpu_torch.tools.plotstats <wf_file.npz|.root> [--verbose]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from npswf_tpu_torch.io.writer import read_wf


def read_wf_root(path: str) -> Dict[str, np.ndarray]:
    """Minimal WF view of a ROOT file for validation: evt/runnum plus a
    computed (runnum, evt) sort order (the ROOT file carries a TTreeIndex
    instead of our sort_order column; lexsort reproduces its ordering,
    ref TEST_2.C:1410)."""
    import uproot
    f = uproot.open(path)
    try:
        t = f["WF"]
        evt = np.asarray(t["evt"].array(library="np"), np.float64).ravel()
        runnum = np.asarray(t["runnum"].array(library="np"),
                            np.float64).ravel()
    finally:
        close = getattr(f, "close", None)
        if close is not None:
            close()
    return {"evt": evt, "runnum": runnum,
            "sort_order": np.lexsort((evt, runnum)),
            "fit_counters": np.array([-1, -1, -1], np.int64)}


def validate(wf: Dict[str, np.ndarray], verbose: bool = False) -> int:
    """Returns the number of continuity violations (0 = pass)."""
    order = wf["sort_order"]
    evt = wf["evt"]
    wrong = 0
    last = None
    for i, row in enumerate(order):
        e = evt[row]
        if verbose:
            print(f"sorted[{i}] -> original row={row}, evt={e:.0f}")
        if last is not None and e != last + 1.0:
            print(f"WRONG {e:.0f} != {last + 1.0:.0f}")
            wrong += 1
        last = e
    return wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wf_file")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.wf_file.endswith(".root"):
        wf = read_wf_root(args.wf_file)
    else:
        wf = read_wf(args.wf_file)
    wrong = validate(wf, verbose=args.verbose)
    n = wf["evt"].shape[0]
    c = wf["fit_counters"]
    if c[0] >= 0:
        print(f"{n} events; fit success={c[0]} failure={c[1]} dropped={c[2]}")
    else:
        print(f"{n} events (ROOT input; fit counters not stored)")
    if wrong == 0:
        print("index OK: sorted event numbers are contiguous")
        return 0
    print(f"index BROKEN: {wrong} continuity violations")
    return 1


if __name__ == "__main__":
    sys.exit(main())

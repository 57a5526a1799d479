# Copied from npswf_tpu/tools/convert_wf_to_root.py; tests/test_torch_host.py pins it there.
"""WF .npz -> ROOT file converter (the inverse data bridge).

The reference's deliverable is a ROOT file whose ``WF`` TTree downstream
collaboration tools read directly (ref TEST_2.C:1383-1432; consumer pattern
README.md:135-161). ``convert_root`` bridges real data IN; this module
bridges the framework's output BACK: it writes the 17-branch ``WF`` tree
(ref TEST_2.C:1387) from a WF .npz, restores the carried FastCloneAndFilter
payload (the filtered ``T`` tree and representable non-T objects,
ref TEST_2.C:88-122), and emits the booked timing histograms.

Contract details:
- WF rows are written in (runnum, evt)-sorted order via the stored
  ``sort_order`` permutation — the same ordering contract the reference
  provides through ``BuildIndex`` + indexed replay (ref :1410-1422;
  plotstats.C:31-46), realized as physical row order since uproot cannot
  write a TTreeIndex.
- ragged branches (``wfampl``/``wftime`` indexed by ``wfnpulse``;
  ``h1time``/``h2time``) are written as jagged arrays (RVec-compatible),
  rebuilt from the flat columns + offsets.
- per-block vector branches (chi2, ampl, ... [nblocks] per event) are
  written as fixed-size arrays.
- framework-only extras (pedwf, Sampener, Sampped, search_overflow) ride
  along in the same tree; readers of the 17 reference branches are
  unaffected.
- the ``T`` tree is restored from ``payload_T.*`` columns in its original
  (unsorted) order — it is a clone of the input, which the reference never
  re-sorts.

Requires ``uproot`` (an optional dependency); the import is guarded and
the test suite exercises this module with a stubbed uproot
(tests/test_convert_wf_root.py). With real uproot, jagged branches need the
``awkward`` package (uproot's own jagged-writing dependency).

Usage: python -m npswf_tpu_torch.tools.convert_wf_to_root wf.npz output.root
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np

from npswf_tpu_torch.io.writer import H1_BINS, H1_HI, H1_LO, H2_BINS, H2_HI, H2_LO, read_wf

# the reference Snapshot's exact branch list (ref TEST_2.C:1387)
REFERENCE_BRANCHES = (
    "chi2", "ampl", "amplwf", "wfnpulse", "Sampampl", "Samptime", "timewf",
    "enertot", "integtot", "pres", "corr_time_HMS", "h1time", "h2time",
    "runnum", "evt", "wfampl", "wftime")
# framework extras carried in the same tree
EXTRA_BRANCHES = ("pedwf", "Sampener", "Sampped", "search_overflow")


def _split_ragged(flat: np.ndarray, offsets: np.ndarray) -> List[np.ndarray]:
    return [flat[offsets[i]:offsets[i + 1]] for i in range(offsets.shape[0] - 1)]


def build_wf_branches(wf: Dict[str, np.ndarray]) -> Dict[str, object]:
    """WF tree branch dict from a read_wf() column dict, (runnum, evt)-sorted.

    Jagged branches are lists of per-event arrays; everything else is a
    numpy array with the event axis first.
    """
    order = np.asarray(wf["sort_order"], np.int64)
    wfampl = _split_ragged(wf["wfampl_flat"], wf["wf_offsets"])
    wftime = _split_ragged(wf["wftime_flat"], wf["wf_offsets"])
    h1 = _split_ragged(wf["h1time_flat"], wf["h_offsets"])
    h2 = _split_ragged(wf["h2time_flat"], wf["h_offsets"])
    branches: Dict[str, object] = {}
    for name in REFERENCE_BRANCHES + EXTRA_BRANCHES:
        if name == "wfampl":
            branches[name] = [wfampl[i] for i in order]
        elif name == "wftime":
            branches[name] = [wftime[i] for i in order]
        elif name == "h1time":
            branches[name] = [h1[i] for i in order]
        elif name == "h2time":
            branches[name] = [h2[i] for i in order]
        elif name in ("evt", "runnum"):
            # the reference carries evt/runnum as doubles (they come from
            # the input T tree's g.evnum/g.runnum, ref TEST_2.C:472-488)
            branches[name] = np.asarray(wf[name], np.float64)[order]
        elif name in wf:
            branches[name] = np.asarray(wf[name])[order]
    return branches


def build_t_branches(wf: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Restore the filtered T tree from payload_T.* columns (original order)."""
    t: Dict[str, object] = {}
    for key in wf:
        if not key.startswith("payload_T.") or key.endswith("__offsets"):
            continue
        name = key[len("payload_T."):]
        offs_key = key + "__offsets"
        if offs_key in wf:
            t[name] = _split_ragged(np.asarray(wf[key]),
                                    np.asarray(wf[offs_key], np.int64))
        else:
            t[name] = np.asarray(wf[key])
    return t


def convert(wf_path: str, output_path: str) -> int:
    try:
        import uproot
    except ImportError as exc:  # pragma: no cover
        raise SystemExit(
            "convert_wf_to_root requires the 'uproot' package to write ROOT "
            "files; install it in an environment with network access and "
            "rerun.") from exc

    wf = read_wf(wf_path)
    branches = build_wf_branches(wf)
    t_branches = build_t_branches(wf)
    n_events = int(np.asarray(wf["evt"]).shape[0])

    with uproot.recreate(output_path) as f:
        f["WF"] = branches
        if t_branches:
            f["T"] = t_branches
        # booked timing histograms (ref TEST_2.C:533-534, 1369-1370)
        f["h1time"] = (np.asarray(wf["h1time_hist"], np.float64),
                       np.linspace(H1_LO, H1_HI, H1_BINS + 1))
        f["h2time"] = (np.asarray(wf["h2time_hist"], np.float64),
                       np.linspace(H2_LO, H2_HI, H2_BINS + 1))
        # restored non-T objects (histograms + scalar parameters)
        scalars: Dict[str, object] = {}
        for key in wf:
            if not key.startswith("payload_obj."):
                continue
            name = key[len("payload_obj."):]
            if name.endswith("__values"):
                base = name[:-len("__values")]
                edges = []
                i = 0
                while True:
                    suffix = "__edges" if i == 0 else f"__edges{i + 1}"
                    ek = f"payload_obj.{base}{suffix}"
                    if ek not in wf:
                        break
                    edges.append(np.asarray(wf[ek]))
                    i += 1
                if edges:
                    f[base] = tuple([np.asarray(wf[key])] + edges)
            elif "__edges" not in name:
                v = np.atleast_1d(np.asarray(wf[key]))
                scalars[name.replace(".", "_")] = v
        if scalars:
            # scalar parameters land in one flat 'params' tree (uproot has
            # no TParameter writer); one row per value
            width = max(x.shape[0] for x in scalars.values())
            f["params"] = {k: np.resize(v, width) for k, v in scalars.items()}
        unrep = wf.get("payload___unrepresentable")
        if unrep is not None and len(unrep):
            print(f"WARNING: {len(unrep)} input object(s) were not "
                  f"representable and are absent from the ROOT output: "
                  f"{[str(u) for u in unrep]}", file=sys.stderr)
    return n_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wf_input", help="WF .npz produced by the framework")
    ap.add_argument("output", help="output .root path")
    args = ap.parse_args(argv)
    n = convert(args.wf_input, args.output)
    print(f"wrote {n} events -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

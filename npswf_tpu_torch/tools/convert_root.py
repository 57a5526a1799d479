# Copied from npswf_tpu/tools/convert_root.py; tests/test_torch_host.py pins it there.
"""ROOT replay file -> raw segment converter.

Bridges real NPS production data into the framework: reads the hcana replay
TTree ``T`` (the reference's input, TEST_2.C:288-338) and writes the columnar
segment container. Fidelity contract = FastCloneAndFilter
(ref TEST_2.C:88-122):

- the 9 analysis branches become the segment's primary fields
  (stream/hits/evt/runnum),
- EVERY T branch except the raw waveform ``NPS.cal.fly.adcSampWaveform`` is
  additionally carried into ``RawSegment.payload`` (flat numeric branches as
  [E] arrays; ragged numeric branches as ``T.<name>`` + ``T.<name>__offsets``
  pairs), so the WF output preserves the whole filtered T tree,
- every representable non-T object is carried too (histograms as
  ``obj.<name>__values``/``__edges``, parameters as scalars); objects that
  cannot be represented are listed in ``payload['__unrepresentable']``.

Requires ``uproot`` (an optional dependency); the import is guarded so the
rest of the framework works without it, and the test suite exercises this
module with a stubbed uproot (tests/test_convert_root.py).

Usage: python -m npswf_tpu_torch.tools.convert_root input.root output_segment.npz
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

WAVEFORM_BRANCH = "NPS.cal.fly.adcSampWaveform"

BRANCHES = {
    "stream": WAVEFORM_BRANCH,
    "adc_counter": "NPS.cal.fly.adcCounter",
    "pulse_amp": "NPS.cal.fly.adcSampPulseAmp",
    "pulse_int": "NPS.cal.fly.adcSampPulseInt",
    "pulse_ped": "NPS.cal.fly.adcSampPed",
    "pulse_time": "NPS.cal.fly.adcSampPulseTime",
    "pulse_time_raw": "NPS.cal.fly.adcSampPulseTimeRaw",
    "evt": "g.evnum",
    "runnum": "g.runnum",
}


def _ragged_to_flat(per_event) -> Tuple[np.ndarray, np.ndarray]:
    """List/object-array of per-event arrays -> (flat f64, offsets [E+1])."""
    counts = np.fromiter((len(x) for x in per_event), np.int64,
                         count=len(per_event))
    offsets = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    if offsets[-1] == 0:
        return np.zeros(0, np.float64), offsets
    flat = np.concatenate([np.asarray(x, np.float64) for x in per_event])
    return flat, offsets


def _branch_to_payload(payload: Dict[str, np.ndarray], skipped: List[str],
                       name: str, arr) -> None:
    """Store one T branch into the payload (flat or ragged numeric)."""
    a = np.asarray(arr)
    if a.dtype != object:
        if not np.issubdtype(a.dtype, np.number):
            skipped.append(f"T.{name}")
            return
        payload[f"T.{name}"] = a
        return
    try:
        flat, offsets = _ragged_to_flat(a)
    except (TypeError, ValueError):
        skipped.append(f"T.{name}")
        return
    payload[f"T.{name}"] = flat
    payload[f"T.{name}__offsets"] = offsets


def _object_to_payload(payload: Dict[str, np.ndarray], skipped: List[str],
                       name: str, obj) -> None:
    """Store one non-T object (the FastCloneAndFilter non-T key copy,
    ref TEST_2.C:101-111) where a numpy representation exists."""
    if hasattr(obj, "to_numpy"):          # histogram-likes
        try:
            parts = obj.to_numpy()
        except Exception:
            skipped.append(name)
            return
        payload[f"obj.{name}__values"] = np.asarray(parts[0])
        for i, edges in enumerate(parts[1:]):
            suffix = "__edges" if i == 0 else f"__edges{i + 1}"
            payload[f"obj.{name}{suffix}"] = np.asarray(edges)
        return
    for attr in ("value", "members"):     # TParameter-likes
        if hasattr(obj, attr):
            try:
                payload[f"obj.{name}"] = np.atleast_1d(
                    np.asarray(getattr(obj, attr)))
                return
            except Exception:
                break
    skipped.append(name)


def convert(input_path: str, output_path: str,
            entry_stop: Optional[int] = None) -> int:
    try:
        import uproot
    except ImportError as exc:  # pragma: no cover
        raise SystemExit(
            "convert_root requires the 'uproot' package to read ROOT files; "
            "install it in an environment with network access and rerun.") from exc

    from npswf_tpu_torch.io.rawstream import RawSegment, write_segment

    if not os.path.exists(input_path):
        raise SystemExit(f"ERROR: Cannot open file: {input_path}")

    with uproot.open(input_path) as f:
        if "T" not in f.keys(cycle=False):
            raise SystemExit(
                f"ERROR: no tree 'T' in {input_path} "
                f"(keys: {sorted(f.keys(cycle=False))})")
        tree = f["T"]
        arrs = tree.arrays(list(BRANCHES.values()), entry_stop=entry_stop,
                           library="np")

        def ragged(branch):
            return _ragged_to_flat(arrs[BRANCHES[branch]])

        stream, so = ragged("stream")
        hits = {}
        ho = None
        for k in ("adc_counter", "pulse_time", "pulse_time_raw",
                  "pulse_amp", "pulse_int", "pulse_ped"):
            hits[k], ho = ragged(k)

        # --- FastCloneAndFilter payload: all of T minus the waveform -----
        payload: Dict[str, np.ndarray] = {}
        skipped: List[str] = []
        for name in tree.keys():
            if name == WAVEFORM_BRANCH:
                continue                  # the one dropped branch (ref :114)
            if name in arrs:              # already read above
                _branch_to_payload(payload, skipped, name, arrs[name])
                continue
            try:
                arr = tree[name].array(entry_stop=entry_stop, library="np")
            except Exception:
                skipped.append(f"T.{name}")
                continue
            _branch_to_payload(payload, skipped, name, arr)

        # --- non-T objects (ref :101-111) --------------------------------
        for key in f.keys(cycle=False):
            if key == "T":
                continue
            try:
                obj = f[key]
            except Exception:
                skipped.append(key)
                continue
            _object_to_payload(payload, skipped, key, obj)
        if skipped:
            payload["__unrepresentable"] = np.asarray(sorted(set(skipped)))
            print(f"WARNING: {len(set(skipped))} object(s) not representable "
                  f"in the segment payload: {sorted(set(skipped))}",
                  file=sys.stderr)

        seg = RawSegment(
            stream=stream, stream_offsets=so,
            adc_counter=hits["adc_counter"], pulse_time=hits["pulse_time"],
            pulse_time_raw=hits["pulse_time_raw"], pulse_amp=hits["pulse_amp"],
            pulse_int=hits["pulse_int"], pulse_ped=hits["pulse_ped"],
            hit_offsets=ho,
            evt=np.asarray(arrs[BRANCHES["evt"]], np.float64),
            runnum=np.asarray(arrs[BRANCHES["runnum"]], np.float64),
            payload=payload)
    write_segment(output_path, seg)
    return seg.n_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--entry-stop", type=int, default=None)
    args = ap.parse_args(argv)
    n = convert(args.input, args.output, args.entry_stop)
    print(f"converted {n} events -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The comparison that decides ``correct``: the program's outputs against the
plain reference's, as a few numbers, each held to the cell's limit
(``limits/<cell>.json``).

- ``decisions_pct``: the share of lanes (event x block) on which a decision
  differs: the pulse count, the slots' validity, the cluster gate, the
  fit's convergence, its iterations, the histogram entries.
- ``time_gap_bins``: the widest gap of a pulse time (wftime, timewf, h1,
  h2) in bins, on lanes whose decisions agree.
- ``ampl_gap_rel``: the widest gap of a fitted amplitude or pedestal
  (wfampl, amplwf, pedwf) over max(|reference|, 1), on lanes whose
  decisions agree.
- ``chi2_gap_rel``: the widest gap of chi2/ndf over max(|reference|, 1e-3)
  on lanes that converged on both sides.
- ``diag_gap_rel``: the widest gap of a diagnostic (ampl, ener, integ, bkg,
  noise, enertot, integtot) over max(|reference|, 1).
- ``columns_unequal`` (segments): how many of the WF file's decode columns
  (pres, corr_time_HMS, Samp*, evt, runnum, search_overflow) differ from
  the reference decode anywhere in the events compared: exact, limit 0.
- ``events_unequal`` (segments): over the whole WF file, how many of the
  segment's events it lacks plus how many it holds more than once or
  holds and the segment does not: exact, limit 0.

A value that is NaN on one side only counts as an infinite gap. Fields a
side does not have (the WF file keeps no gate or iteration count) are left
out of the comparison.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

NUMBERS = ("decisions_pct", "time_gap_bins", "ampl_gap_rel", "chi2_gap_rel",
           "diag_gap_rel")
SEGMENT_NUMBERS = NUMBERS + ("columns_unequal", "events_unequal")
DIAG_FIELDS = ("ampl", "ener", "integ", "bkg", "noise", "enertot", "integtot")
DECODE_COLUMNS = ("pres", "corr_time_HMS", "Sampampl", "Samptime",
                  "Sampener", "Sampped", "evt", "runnum", "search_overflow")


def _gap(a, b, scale) -> np.ndarray:
    """|a - b| / scale, with a NaN on one side an infinite gap and on both
    sides none."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.abs(a - b) / scale
    na, nb = np.isnan(a), np.isnan(b)
    d = np.where(na & nb, 0.0, d)
    return np.where(na ^ nb, np.inf, np.where(np.isnan(d), np.inf, d))


def _max(x) -> float:
    x = np.asarray(x, np.float64)
    return float(x.max()) if x.size else 0.0


def compare(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
            dt: float) -> Dict[str, float]:
    """The numbers of one batch of lanes. ``prog`` and ``ref`` hold [E, B]
    lane fields, [E, B, P] slot fields and [E] event fields by the port's
    PipelineOutput names; ``prog`` may also hold ``h_count`` [E] and the
    flat ``h1_flat``/``h2_flat`` per event in place of h_mask."""
    E, B = ref["wfnpulse"].shape
    lane_bad = prog["wfnpulse"] != ref["wfnpulse"]
    conv_p = (prog["fit_converged"] if "fit_converged" in prog
              else prog["chi2"] != -100.0)
    conv_r = (ref["fit_converged"] if "fit_converged" in prog
              else ref["chi2"] != -100.0)
    lane_bad |= conv_p != conv_r
    for k in ("gate", "fit_n_iter"):
        if k in prog:
            lane_bad |= prog[k] != ref[k]
    P = ref["wftime"].shape[-1]
    valid_r = np.arange(P)[None, None, :] < ref["wfnpulse"][..., None]
    if "pulse_valid" in prog:
        lane_bad |= (prog["pulse_valid"] != ref["pulse_valid"]).any(-1)
        valid_r = ref["pulse_valid"]
    if "h_mask" in prog:
        lane_bad |= (prog["h_mask"] != ref["h_mask"]).any(-1)
    n_bad = int(lane_bad.sum())
    h_event_ok = np.ones(E, bool)
    if "h_count" in prog:
        h_event_ok = prog["h_count"] == ref["h_mask"].reshape(E, -1).sum(1)
        # an event whose histogram entries differ counts one lane more
        n_bad += int((~h_event_ok & ~lane_bad.any(1)).sum())
    out = {"decisions_pct": 100.0 * n_bad / (E * B)}

    good = ~lane_bad                                       # [E, B]
    slots = good[..., None] & valid_r
    fitted = ref["fit_n_iter"] > 0
    # fitted lanes carry times in ns, the others in bins
    unit = np.where(fitted, dt, 1.0)
    gaps = [_gap(prog["wftime"], ref["wftime"], unit[..., None])[slots],
            _gap(prog["timewf"], ref["timewf"], unit)[good & fitted]]
    if "h_mask" in prog:
        hm = ref["h_mask"] & good[..., None]
        gaps += [_gap(prog["h1time"], ref["h1time"], 1.0)[hm],
                 _gap(prog["h2time"], ref["h2time"], dt)[hm]]
    else:
        for e in np.nonzero(h_event_ok)[0]:
            hm = ref["h_mask"][e]
            gaps += [_gap(prog["h1_flat"][e], ref["h1time"][e][hm], 1.0),
                     _gap(prog["h2_flat"][e], ref["h2time"][e][hm], dt)]
    out["time_gap_bins"] = max(_max(x) for x in gaps)

    def rel(k, floor, mask=None):
        g = _gap(prog[k], ref[k], np.maximum(np.abs(ref[k]), floor))
        return _max(g if mask is None else g[mask])
    out["ampl_gap_rel"] = max(rel("wfampl", 1.0, slots),
                              rel("amplwf", 1.0, good & fitted),
                              rel("pedwf", 1.0, good))
    out["chi2_gap_rel"] = rel("chi2", 1e-3, good & conv_r & conv_p)
    out["diag_gap_rel"] = max(rel(k, 1.0) for k in DIAG_FIELDS if k in prog)
    return out


def merge(readings) -> Dict[str, float]:
    """The numbers over several batches: the widest gap, the share of all
    lanes, the sum of unequal columns."""
    readings = list(readings)
    out = {}
    for k in readings[0]:
        vals = [r[k] for r in readings]
        out[k] = (float(np.mean(vals)) if k == "decisions_pct"
                  else float(max(vals)) if k != "columns_unequal"
                  else float(sum(vals)))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            missing: Optional[str] = None):
    """(correct, [(name, value, limit)]); a missing answer is not correct."""
    rows = [(k, numbers.get(k, float("inf")), limits[k]) for k in limits]
    ok = missing is None and all(v <= lim for _, v, lim in rows)
    return ok, rows


# ----------------------------------------------------------------------
# the WF file's rows as the comparison's fields
# ----------------------------------------------------------------------
def wf_rows(wf: Dict[str, np.ndarray], rows: np.ndarray, B: int, P: int
            ) -> Dict[str, np.ndarray]:
    """Events ``rows`` of a WF file as dense fields: the ragged pulses back
    in their (block, slot) places by each block's wfnpulse, the histogram
    entries as each event's count and flat values."""
    E = rows.size
    npulse = wf["wfnpulse"][rows].reshape(E, B)
    offs = wf["wf_offsets"]
    hoffs = wf["h_offsets"]
    mask = np.arange(P)[None, None, :] < npulse[..., None]
    wt = np.zeros((E, B, P))
    wa = np.zeros((E, B, P))
    h1, h2, hc = [], [], np.zeros(E, np.int64)
    for i, r in enumerate(rows):
        wt[i][mask[i]] = wf["wftime_flat"][offs[r]:offs[r + 1]]
        wa[i][mask[i]] = wf["wfampl_flat"][offs[r]:offs[r + 1]]
        h1.append(wf["h1time_flat"][hoffs[r]:hoffs[r + 1]])
        h2.append(wf["h2time_flat"][hoffs[r]:hoffs[r + 1]])
        hc[i] = hoffs[r + 1] - hoffs[r]
    out = dict(wfnpulse=npulse, wftime=wt, wfampl=wa, h_count=hc,
               h1_flat=h1, h2_flat=h2)
    for k in ("chi2", "timewf", "amplwf", "pedwf", "ampl", "enertot",
              "integtot"):
        out[k] = wf[k][rows]
    return out


def wf_view(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Dense outputs cut to what a WF file keeps (``wf_rows``'s fields), so
    that a stand-in for the program on a segment cell is compared on the
    same fields as the program's file."""
    keep = ("wfnpulse", "wftime", "wfampl", "chi2", "timewf", "amplwf",
            "pedwf", "ampl", "enertot", "integtot")
    v = {k: out[k] for k in keep}
    hm = out["h_mask"]
    E = hm.shape[0]
    v["h_count"] = hm.reshape(E, -1).sum(1)
    v["h1_flat"] = [out["h1time"][e][hm[e]] for e in range(E)]
    v["h2_flat"] = [out["h2time"][e][hm[e]] for e in range(E)]
    return v


def columns_unequal(wf: Dict[str, np.ndarray], rows: np.ndarray,
                    dec: Dict[str, np.ndarray], B: int) -> int:
    """Decode columns of the WF file's ``rows`` that differ from the
    reference decode ``dec`` (search_overflow: none with every lane
    searched)."""
    want = dict(pres=dec["pres"][:, :B].astype(np.int32),
                corr_time_HMS=dec["corr_time_HMS"],
                Sampampl=dec["Sampampl"], Samptime=dec["Samptime"],
                Sampener=dec["Sampener"], Sampped=dec["Sampped"],
                evt=dec["evt"], runnum=dec["runnum"],
                search_overflow=np.zeros((rows.size, B), np.int8))
    n = 0
    for k in DECODE_COLUMNS:
        got = wf[k][rows]
        if got.shape != want[k].shape or not np.array_equal(
                np.asarray(got, np.float64), np.asarray(want[k], np.float64)):
            n += 1
    return n


def events_unequal(got_evt: np.ndarray, want_evt: np.ndarray) -> int:
    """The events of ``want_evt`` that ``got_evt`` lacks plus the rows of
    ``got_evt`` beyond one a wanted event, each event number counted as
    often as it appears on a side."""
    keys, inv = np.unique(np.concatenate([got_evt, want_evt]),
                          return_inverse=True)
    got = np.bincount(inv[:len(got_evt)], minlength=keys.size)
    want = np.bincount(inv[len(got_evt):], minlength=keys.size)
    return int(np.abs(got - want).sum())


def as_written(ref: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference's outputs as the WF file holds them: every float
    through float32 (the writer packet's type) to float64."""
    return {k: (v.astype(np.float32).astype(np.float64)
                if np.issubdtype(v.dtype, np.floating) else v)
            for k, v in ref.items()}

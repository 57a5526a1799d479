# Copied from npswf_tpu/io/rawstream.py; tests/test_torch_host.py pins it there.
"""Raw event-segment container.

The reference reads ROOT TTrees whose per-event payload is the variable-length
``NPS.cal.fly.adcSampWaveform`` stream — ``[slot, nsamp, s0..s(nsamp-1)]*`` —
plus the hcana per-hit arrays (ref TEST_2.C:318-335, 854-889). This module
defines the framework's columnar segment container with the same information
content:

- ``stream``      concatenated f64 sample streams, with ``stream_offsets``
                  [E+1] delimiting events (the ragged Ndata layout)
- hcana hit arrays (``adc_counter``, ``pulse_time``, ``pulse_time_raw``,
  ``pulse_amp``, ``pulse_int``, ``pulse_ped``) concatenated with
  ``hit_offsets`` [E+1]
- ``evt`` / ``runnum`` per event
- ``payload``     opaque extra arrays carried through to the output file
                  (the FastCloneAndFilter equivalent, ref TEST_2.C:88-122:
                  everything except the raw waveform branch is preserved)

Storage is a single .npz file — columnar, compressed, mmap-friendly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig


@dataclass
class RawSegment:
    stream: np.ndarray           # [sum Ndata] f64
    stream_offsets: np.ndarray   # [E+1] i64
    adc_counter: np.ndarray      # [sum hits] f64
    pulse_time: np.ndarray       # [sum hits] f64
    pulse_time_raw: np.ndarray   # [sum hits] f64
    pulse_amp: np.ndarray        # [sum hits] f64
    pulse_int: np.ndarray        # [sum hits] f64
    pulse_ped: np.ndarray        # [sum hits] f64
    hit_offsets: np.ndarray      # [E+1] i64
    evt: np.ndarray              # [E] f64 (g.evnum is Double_t in the source)
    runnum: np.ndarray           # [E] f64
    payload: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_events(self) -> int:
        return self.evt.shape[0]

    def event_stream(self, i: int) -> np.ndarray:
        return self.stream[self.stream_offsets[i]:self.stream_offsets[i + 1]]

    def event_hits(self, i: int) -> Dict[str, np.ndarray]:
        s, e = self.hit_offsets[i], self.hit_offsets[i + 1]
        return {k: getattr(self, k)[s:e] for k in
                ("adc_counter", "pulse_time", "pulse_time_raw",
                 "pulse_amp", "pulse_int", "pulse_ped")}

    def slice(self, lo: int, hi: int) -> "RawSegment":
        so = self.stream_offsets
        ho = self.hit_offsets
        return RawSegment(
            stream=self.stream[so[lo]:so[hi]],
            stream_offsets=(so[lo:hi + 1] - so[lo]).copy(),
            adc_counter=self.adc_counter[ho[lo]:ho[hi]],
            pulse_time=self.pulse_time[ho[lo]:ho[hi]],
            pulse_time_raw=self.pulse_time_raw[ho[lo]:ho[hi]],
            pulse_amp=self.pulse_amp[ho[lo]:ho[hi]],
            pulse_int=self.pulse_int[ho[lo]:ho[hi]],
            pulse_ped=self.pulse_ped[ho[lo]:ho[hi]],
            hit_offsets=(ho[lo:hi + 1] - ho[lo]).copy(),
            evt=self.evt[lo:hi], runnum=self.runnum[lo:hi],
            payload=self.payload)


def encode_event_stream(cfg: NPSConfig, signal: np.ndarray,
                        pres: Optional[np.ndarray] = None,
                        scint: Optional[np.ndarray] = None) -> np.ndarray:
    """Encode dense [B, T] waveforms into the raw [slot, nsamp, samples]* stream.

    ``pres`` selects which blocks appear; scintillator channels (raw slots
    2000/2001) can be appended via ``scint`` [2, T]. Inverse of the decode at
    ref TEST_2.C:854-889.
    """
    B, T = signal.shape
    if pres is None:
        pres = np.ones(B, dtype=bool)
    chunks: List[np.ndarray] = []
    for b in np.nonzero(pres)[0]:
        chunks.append(np.concatenate([[float(b), float(T)], signal[b]]))
    if scint is not None:
        for i, slot in enumerate((cfg.scint_slot_a, cfg.scint_slot_b)):
            chunks.append(np.concatenate([[float(slot), float(T)], scint[i]]))
    if not chunks:
        return np.zeros(0)
    return np.concatenate(chunks)


def build_segment(cfg: NPSConfig, streams: List[np.ndarray],
                  hits: List[Dict[str, np.ndarray]], evt: np.ndarray,
                  runnum: np.ndarray,
                  payload: Optional[Dict[str, np.ndarray]] = None) -> RawSegment:
    so = np.zeros(len(streams) + 1, dtype=np.int64)
    np.cumsum([s.shape[0] for s in streams], out=so[1:])
    ho = np.zeros(len(hits) + 1, dtype=np.int64)
    np.cumsum([h["adc_counter"].shape[0] for h in hits], out=ho[1:])

    def cat(key):
        arrs = [h[key] for h in hits]
        return np.concatenate(arrs) if arrs else np.zeros(0)

    return RawSegment(
        stream=np.concatenate(streams) if streams else np.zeros(0),
        stream_offsets=so,
        adc_counter=cat("adc_counter"), pulse_time=cat("pulse_time"),
        pulse_time_raw=cat("pulse_time_raw"), pulse_amp=cat("pulse_amp"),
        pulse_int=cat("pulse_int"), pulse_ped=cat("pulse_ped"),
        hit_offsets=ho, evt=np.asarray(evt, np.float64),
        runnum=np.asarray(runnum, np.float64), payload=payload or {})


_FIELDS = ("stream", "stream_offsets", "adc_counter", "pulse_time",
           "pulse_time_raw", "pulse_amp", "pulse_int", "pulse_ped",
           "hit_offsets", "evt", "runnum")


def write_segment(path: str, seg: RawSegment) -> None:
    data = {f: getattr(seg, f) for f in _FIELDS}
    for k, v in seg.payload.items():
        data[f"payload_{k}"] = v
    np.savez_compressed(path, **data)


def read_segment(path: str) -> RawSegment:
    z = np.load(path)
    payload = {k[len("payload_"):]: z[k] for k in z.files if k.startswith("payload_")}
    return RawSegment(**{f: z[f] for f in _FIELDS}, payload=payload)

# decode_event_golden is copied from npswf_tpu/golden/reference.py;
# tests/test_torch_host.py pins it there.
"""Scalar numpy oracle of the reference's raw-stream decode.

``decode_event_golden`` <- raw-stream unpack, TEST_2.C:854-889. It is the
numpy decode path of ``io.decode`` (``use_native=False``) and the oracle the
native decoder is tested against.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from npswf_tpu_torch.core.config import NPSConfig


# ----------------------------------------------------------------------
# Raw-stream decode (ref TEST_2.C:854-889)
# ----------------------------------------------------------------------
def decode_event_golden(cfg: NPSConfig, stream: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Unpack the [blk, nsamp, s0..s(nsamp-1)]* stream.

    Returns (signal[nblocks, ntime], pres[nslots], minsignal[nblocks], bad).
    Slots 2000/2001 remap to 1080/1081 (scintillators) and are flagged present
    but carry no samples into ``signal`` (ref :862-865, 881-886). ``bad`` is
    -1 for a clean decode, the offending slot id when a slot outside
    [0, nslots) aborts the decode (ref :867-872), -2 when an nsamp runs past
    the event's stream (truncated/corrupt event; samples are clamped, never
    read out of range), and -3 when the whole stream exceeds ndata_max and
    the event is skipped (ref :830-836). Samples past ntime are dropped
    (matching the native decoder's clamp; the reference's fixed
    signal[bloc*ntime + it] write would corrupt neighbors there — UB we
    define away).
    """
    B, T = cfg.nblocks, cfg.ntime
    signal = np.zeros((B, T))
    pres = np.zeros(cfg.nslots, dtype=np.int32)
    minsignal = np.full(B, 1e6)
    ns = 0
    n = stream.shape[0]
    bad = -1
    if n > cfg.ndata_max:                        # Ndata guard (ref :830-836)
        return signal, pres, minsignal, -3
    while ns + 2 <= n:
        bloc = int(stream[ns]); ns += 1
        nsamp = int(stream[ns]); ns += 1
        if bloc == cfg.scint_slot_a:
            bloc = 1080
        if bloc == cfg.scint_slot_b:
            bloc = 1081
        if bloc < 0 or bloc > cfg.nslots - 0.5:
            bad = bloc
            break
        pres[bloc] = 1
        if ns + nsamp > n:
            bad = -2
        lim = min(nsamp, T, n - ns)
        if 0 <= bloc < B:
            for it in range(lim):
                signal[bloc, it] = stream[ns + it]
                minsignal[bloc] = min(minsignal[bloc], signal[bloc, it])
        ns += nsamp
    return signal, pres, minsignal, bad

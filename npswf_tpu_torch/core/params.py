"""The system's "weights" (its calibration arrays) and its event batches as
tensors.

``calib_to_torch`` takes ``CalibrationBundle.device_arrays(cfg)`` (numpy,
what the reference package uploads) and returns the port's tensors; the
padded segment planes ``coeffs_pad`` are built on demand by the spline
model's ``prepare_aux``, as in the reference package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from npswf_tpu_torch.engine.pipeline import EventBatch


def calib_to_torch(arrays: Dict[str, np.ndarray], device,
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Calibration arrays -> tensors on ``device``: floating arrays in
    ``dtype``, flags as bool."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            out[k] = torch.as_tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.floating):
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
        else:
            out[k] = torch.as_tensor(a, device=device)
    return out


def batch_to_torch(signal: np.ndarray, pres: np.ndarray,
                   corr_time_HMS: np.ndarray, device, dtype: torch.dtype,
                   evt: Optional[np.ndarray] = None,
                   runnum: Optional[np.ndarray] = None,
                   minsignal: Optional[np.ndarray] = None) -> EventBatch:
    """Numpy event arrays ([E, B, T] signal, [E, B] present flags, [E] HMS
    correction) -> EventBatch on ``device``. Event and run numbers default
    to 0..E-1 and 0."""
    E = signal.shape[0]

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return EventBatch(
        signal=f(signal),
        pres=torch.as_tensor(np.asarray(pres).astype(bool), device=device),
        corr_time_HMS=f(corr_time_HMS),
        evt=torch.as_tensor(np.arange(E) if evt is None else evt,
                            dtype=torch.int32, device=device),
        runnum=torch.as_tensor(np.zeros(E) if runnum is None else runnum,
                               dtype=torch.int32, device=device),
        minsignal=None if minsignal is None else f(minsignal))

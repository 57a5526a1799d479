"""Per-sample error model for the chi^2 fit.

Counterpart of npswf_tpu/fit/errors.py (ref TEST_2.C:946-955):
e = sqrt(|y| * 4.096 / 2) / 4.096, with any e < 1 replaced by the y=1
floor value.
"""
from __future__ import annotations

import math

import torch

from npswf_tpu.core.config import NPSConfig


def error_model(cfg: NPSConfig, y: torch.Tensor) -> torch.Tensor:
    s = cfg.err_scale
    e = torch.sqrt(torch.abs(y * s / 2.0)) / s
    floor = math.sqrt(abs(cfg.err_floor_input * s / 2.0)) / s
    return torch.where(e < 1.0, floor, e)

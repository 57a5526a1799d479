"""Shared helpers of the benchmark's own tests (run on the CPU with
``python -m pytest wfbench/tests``; the test marked ``cuda`` runs on the
card). Cells are cut to a few events here, so that the plain path, which
both the program and the reference run on the CPU, finishes in seconds."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

for _name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_name, "2")

# each mix cut to a size a test run holds
TINY = {"process_batch": dict(events_per_call=2, pool=2, check_calls=1,
                              trace_calls=2),
        "run_segment": dict(events=4, batch_size=2, warm_events=2,
                            check_batches=1)}


def tiny_cell(name: str):
    """The cell ``name`` with its traffic cut to TINY."""
    from wfbench import spec
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic, **TINY[cell.traffic["entry"]])
    return cell


def run_tiny(cell, seed: int = 2 ** 31 + 11, trace: bool = False):
    import time
    import torch
    from wfbench import harness
    return harness.run(cell, seed, 0.01, trace, torch.device("cpu"),
                       time.perf_counter(), workers=1)


@pytest.fixture
def tiny():
    return tiny_cell

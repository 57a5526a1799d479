"""One compute thread in each test process, imported by the port's CPU
test files (``tests/test_torch_*.py``; not by test_torch_package.py, whose
card tests run on a machine where ``tests`` may name another package).

The suite runs in six pytest-xdist workers on an eight-core host. With
torch's default of one intra-op thread a core, and numpy's OpenBLAS of
one spinning thread a core, six workers put dozens of busy threads on
eight cores: the port's plain versions (loops of small tensor operations,
such as the normal equations summed bin by bin) then ran six to eight
times slower in wall time than with one thread a process. So each process
keeps one torch thread and, where ``threadpoolctl`` is installed, one
OpenBLAS and one OpenMP thread; the spawned mesh ranks and the CLI
subprocesses inherit the thread variables below. The thread count is no
part of any comparison: the port's files pass alike with one thread a
process and with torch's and OpenBLAS's defaults.
"""
import os

import torch

for _name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_name] = "1"
torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:     # the card's machine may lack it; torch's own is set
    pass
else:
    threadpool_limits(limits=1)

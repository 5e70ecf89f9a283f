"""Torch's intra-op threads in a pytest-xdist worker: its share of the cores.

Every xdist worker is a process of its own, and torch's OpenMP pool starts
one thread a core in each. Six workers on eight cores then run 48 spinning
threads against each other: a case that takes 4 s alone took over 10 min
that way (``test_torch_dryrun.py::test_materialized_shard_steps_flat_and_cuda``,
six copies at once). Each worker gets ``cores // workers`` threads instead,
and the processes a case starts inherit the count through
``OMP_NUM_THREADS``. Outside xdist nothing changes.

Each port test module imports this first; the count is set once a process.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))

if _WORKERS > 1:
    THREADS = max(1, (os.cpu_count() or 1) // _WORKERS)
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)

"""Under pytest-xdist, each worker's torch (and the processes its tests
start, through OMP_NUM_THREADS) runs on its share of the CPUs."""

import os

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    import torch

    _threads = max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    torch.set_num_threads(_threads)
    os.environ["OMP_NUM_THREADS"] = str(_threads)

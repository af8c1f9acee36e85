"""The CPU thread budget of the port's tests under pytest-xdist.

PyTorch's CPU kernels start one OpenMP thread per core in every process,
and the suite is run in several xdist workers at once (``-n 6`` on an
8-core host): the workers' threads then contend for the same
cores, and OpenMP's idle threads spin while they wait. Measured on an
8-core host, 6 workers, the port's test files alone: 2,774 test-seconds
(560 s wall) with PyTorch's default budget, 795 (185 s wall) with one
thread per worker.

``tests/test_torch_threads.py`` applies :func:`worker_threads` when it is
imported. A CLI test that starts a subprocess hands it the same budget
through ``OMP_NUM_THREADS`` (:func:`subprocess_env`).
"""

import os

import torch


def worker_threads() -> int | None:
    """This xdist worker's share of the cores, ``cpu_count // workers`` and
    at least 1, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


def subprocess_env(**extra) -> dict:
    """The environment for a subprocess of a test: this process's, with
    its thread budget, plus ``extra``."""
    return {**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads()), **extra}

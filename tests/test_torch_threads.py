"""Each pytest-xdist worker's CPU thread budget (``tests/torch_threads.py``).

Every xdist worker imports every test module while it collects, before
any test runs, so importing this module gives each worker its share of
the cores for all the tests it will run. A run without xdist keeps
PyTorch's default.
"""

import torch

from tests.torch_threads import subprocess_env, worker_threads

if worker_threads() is not None:
    torch.set_num_threads(worker_threads())


def test_each_worker_takes_its_share_of_the_cores():
    share = worker_threads()
    if share is not None:
        assert torch.get_num_threads() == share
    assert subprocess_env(FRT_TORCH_DEVICE="cpu")["OMP_NUM_THREADS"] == str(torch.get_num_threads())

"""The scale flags that the port's ``main`` and ``test`` honour.

Each flag, for each CLI whose JAX counterpart honours it, reaches its
effect (no process is started here: ``torch.multiprocessing.spawn`` and
``init_process_group`` are replaced by recorders):

* ``--num_devices`` / ``--model_parallel``: ``main`` spawns the JAX
  ``main``'s mesh size (the largest ``k <= avail``, a multiple of the model
  axis, whose data part divides the per-host batch); ``test`` spawns
  ``max((avail // mp) * mp, mp)``;
* ``--num_hosts`` / ``--host_id`` / ``--coordinator``: a rank joins as
  ``host_id * local + local_rank`` of ``num_hosts * local`` over
  ``tcp://<coordinator>`` (a URL such as ``file://`` as it is), on gloo
  (the CPU's backend);
* ``--remat_backbone``: ``main`` builds the model with VGG16 (whole) or
  every ResNet50 bottleneck checkpointed;
* ``--ckpt_backend orbax`` / ``--async_checkpoint``: the epoch's
  checkpoint is a directory, written in the background (a pending save
  after the epoch returns).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.engine.train import BATCH_KEYS, train_one_epoch
from faster_rcnn_pytorch_tpu_torch.parallel.train_step import METRIC_KEYS, init_train_state
from faster_rcnn_pytorch_tpu_torch.utils import checkpoint as ck


class Spawned(Exception):
    pass


@pytest.fixture
def spawn(monkeypatch):
    """Record ``torch.multiprocessing.spawn``'s call instead of spawning."""
    import torch.multiprocessing as tmp

    calls = []
    monkeypatch.setattr(tmp, "spawn", lambda fn, args, nprocs, join: calls.append((fn, args, nprocs)))
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    return calls


def _cli(name):
    import importlib

    return importlib.import_module(f"faster_rcnn_pytorch_tpu_torch.{name}").main


@pytest.mark.parametrize(
    "flags,nprocs",
    [
        (["--num_devices", "2", "--batch_size", "2"], 2),
        (["--num_devices", "4", "--batch_size", "2"], 2),  # data ranks divide the batch
        (["--num_devices", "3", "--batch_size", "4"], 2),
        (["--num_devices", "4", "--model_parallel", "2", "--batch_size", "2"], 4),
        (["--num_devices", "3", "--model_parallel", "2", "--batch_size", "1"], 2),
    ],
)
def test_main_spawns_the_jax_mesh_size(spawn, tmp_path, flags, nprocs):
    assert _cli("main")(["--data_root", str(tmp_path / "absent"), *flags]) == 0
    (_, args, n), = spawn
    assert n == nprocs and args[1] == nprocs  # local world handed to each rank


@pytest.mark.parametrize(
    "flags,nprocs",
    [
        (["--num_devices", "2"], 2),
        (["--num_devices", "3"], 3),
        (["--num_devices", "3", "--model_parallel", "2"], 2),
        (["--num_devices", "1", "--model_parallel", "2"], 2),
    ],
)
def test_test_spawns_its_eval_ranks(spawn, tmp_path, flags, nprocs):
    assert _cli("test")(["--data_root", str(tmp_path / "absent"), *flags]) == 0
    (_, args, n), = spawn
    assert n == nprocs and args[1] == nprocs


@pytest.mark.parametrize(
    "flags,rank,world,init_method",
    [
        (["--num_hosts", "2", "--host_id", "0", "--coordinator", "10.0.0.1:1234"], 0, 2,
         "tcp://10.0.0.1:1234"),
        (["--num_hosts", "2", "--host_id", "1", "--coordinator", "10.0.0.1:1234"], 1, 2,
         "tcp://10.0.0.1:1234"),
        (["--num_hosts", "3", "--host_id", "2", "--coordinator", "file:///tmp/rdv", "--num_devices",
          "2", "--batch_size", "6"], 5, 6, "file:///tmp/rdv"),
    ],
)
def test_hosts_join_one_group(spawn, tmp_path, monkeypatch, flags, rank, world, init_method):
    joined = []

    def init_process_group(backend, init_method, rank, world_size, timeout):
        joined.append((backend, init_method, rank, world_size))
        raise Spawned

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    assert _cli("main")(["--data_root", str(tmp_path / "absent"), *flags]) == 0
    (fn, args, n), = spawn
    threads = torch.get_num_threads()
    try:
        with pytest.raises(Spawned):
            fn(n - 1, *args)  # the host's last local rank
    finally:
        torch.set_num_threads(threads)  # the rank takes its share of them
    assert joined == [("gloo", init_method, rank, world)]


@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_main_builds_a_remat_backbone(monkeypatch, tmp_path, generation):
    from faster_rcnn_pytorch_tpu_torch.data import loader
    from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn
    from faster_rcnn_pytorch_tpu_torch.models.resnet import Bottleneck
    from faster_rcnn_pytorch_tpu_torch.models.vgg import VGG16Features

    built = []
    build = faster_rcnn.build_model

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs)[0])
        raise Spawned

    monkeypatch.setattr(loader, "build_dataloader", lambda opts: (None, None))
    monkeypatch.setattr(faster_rcnn, "build_model", spy)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    with pytest.raises(Spawned):
        _cli("main")(["--data_root", str(tmp_path), "--model_generation", generation,
                      "--remat_backbone", "true"])
    kind = VGG16Features if generation == "legacy" else Bottleneck
    remat = [m for m in built[0].modules() if isinstance(m, kind)]
    assert remat and all(m.remat for m in remat)


class _Loader:
    def __len__(self):
        return 1

    def epoch(self, epoch):
        yield {k: np.zeros((1, 1), np.float32) for k in BATCH_KEYS}


@pytest.mark.parametrize("async_save", [False, True])
def test_the_epoch_checkpoint_is_a_directory(tmp_path, async_save):
    model = torch.nn.Linear(3, 2)
    state = init_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    flags = ["--ckpt_backend", "orbax", "--log_dir", str(tmp_path), "--name", "run"]
    opts = load_options(flags + (["--async_checkpoint", "true"] if async_save else []))
    step = lambda state, batch, gen: {k: torch.zeros(()) for k in METRIC_KEYS}  # noqa: E731
    train_one_epoch(state, step, _Loader(), 0, opts, lambda s: 0.1)
    path = ck.checkpoint_path(str(tmp_path), "run", 0)
    assert bool(ck._PENDING) == async_save  # the save in flight
    ck.wait_for_checkpoints()
    assert os.path.isdir(path) and not os.path.exists(path + ".tmp")
    fresh = torch.nn.Linear(3, 2)
    ck.load_checkpoint(path, init_train_state(fresh, torch.optim.SGD(fresh.parameters(), lr=0.1)))
    assert torch.equal(fresh.weight, model.weight)

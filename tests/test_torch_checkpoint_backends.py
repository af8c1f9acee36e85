"""The port's checkpoint backends: ``--ckpt_backend flax|orbax`` and
``--async_checkpoint``.

* Round trips of the ResNet50-FPN train state (model, momentum, step,
  metadata) through the file backend, the directory backend
  (``torch.distributed.checkpoint``) and an asynchronous directory save:
  every tensor and number back bit for bit; an asynchronous save holds
  the state of its call even when the parameters change before it is
  written; the directory appears at its path only when complete.
* Pruning waits for the save in flight, keeps the newest, deletes
  directories as it deletes files, and never the ``best`` copy.
* A checkpoint written by two ranks with ``--model_parallel 2`` (fc6/fc7
  split) holds the single-device state (both classifier aliases): it
  loads ``strict=True`` through the ``test`` CLI's resolution and, model
  and momentum, into a one-process train state, and resumes into the two
  ranks' layout (each its shards, bit for bit); the ``test`` CLI
  evaluates a VOC tree from the directory one.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.parallel import train_step as pts
from faster_rcnn_pytorch_tpu_torch.utils import checkpoint as ck
from tests import torch_dist_workers as w
from tests.test_data import VOC_XML
from tests.torch_dist import run_ranks


def _state(generation="fpn"):
    state = w.new_state(generation)
    step_fn = pts.make_train_step(w.CONFIGS[generation], pts.make_lr_schedule("constant", 1e-3, 1, 1))
    step_fn(state, w.rows(w.make_batch(2, generation=generation), 0, 2), torch.Generator().manual_seed(1))
    return state


def _snapshot(state):
    return (
        {k: v.clone() for k, v in state.model.state_dict().items()},
        {i: s["momentum_buffer"].clone() for i, s in state.optimizer.state_dict()["state"].items()},
    )


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A test's checkpoints (330 MB each) go when it is done."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def fpn_state():
    return _state()


def _empty_state(generation="fpn", num_classes=w.NUM_CLASSES):
    model = w.new_model(generation, num_classes=num_classes)
    return pts.init_train_state(model, pts.make_optimizer(model))


@pytest.mark.parametrize("backend,async_save", [("flax", False), ("orbax", False), ("orbax", True)])
def test_round_trip(fpn_state, tmp_path, backend, async_save):
    path = str(tmp_path / "run.0.pt")
    model, momentum = _snapshot(fpn_state)
    ck.save_checkpoint(path, fpn_state, {"epoch": 0, "map": 0.25}, backend, async_save)
    try:
        if async_save:
            assert not os.path.exists(path)  # in flight, written under path.tmp
            with torch.no_grad():  # training goes on; the save keeps the call's state
                for p in fpn_state.model.parameters():
                    p.add_(1.0)
        ck.wait_for_checkpoints()
    finally:
        if async_save:
            with torch.no_grad():
                for p in fpn_state.model.parameters():
                    p.sub_(1.0)
    assert os.path.isdir(path) == (backend == "orbax") and not os.path.exists(path + ".tmp")
    other = _empty_state()
    _, meta = ck.load_checkpoint(path, other)
    assert meta == {"epoch": 0, "map": 0.25} and other.step == 1
    for k, v in model.items():
        assert torch.equal(other.model.state_dict()[k], v), k
    got = other.optimizer.state_dict()["state"]
    assert got.keys() == momentum.keys()
    for i, v in momentum.items():
        assert torch.equal(got[i]["momentum_buffer"], v), i


def test_prune_waits_for_the_save_in_flight(fpn_state, tmp_path):
    log = str(tmp_path)
    for epoch in range(3):
        ck.save_checkpoint(ck.checkpoint_path(log, "run", epoch), fpn_state, {"epoch": epoch},
                           "orbax", async_save=True)
    ck.save_checkpoint(ck.checkpoint_path(log, "run", "best"), fpn_state, {}, "orbax", True)
    removed = ck.prune_checkpoints(log, "run", keep_last=1)
    assert removed == [ck.checkpoint_path(log, "run", e) for e in (0, 1)]
    saves_dir = os.path.dirname(removed[0])
    assert sorted(os.listdir(saves_dir)) == ["run.2.pt", "run.best.pt"]  # none in flight
    assert all(os.path.isdir(os.path.join(saves_dir, s)) for s in os.listdir(saves_dir))


@pytest.fixture(scope="module")
def tp_checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_checkpoint")
    out = run_ranks(
        w.jobs, 2, tmp / "ranks", [("tp_checkpoint", dict(directory=str(tmp)))],
        model_parallel=2, timeout=600,
    )
    yield tmp, out[0][0]
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("backend", ["flax", "orbax"])
def test_model_parallel_checkpoint_loads_at_one_process(tp_checkpoints, backend):
    tmp, want = tp_checkpoints
    assert want["resumes"][backend]  # back into the two ranks' layout
    path = str(tmp / f"run.{backend}.pt")
    assert os.path.isdir(path) == (backend == "orbax")
    model = w.new_model("legacy", num_classes=21)
    note = ck.resolve_and_load_params(load_options(["--checkpoint", path]), model)  # strict
    assert note == f"loaded {path} (epoch 3)"
    assert {k: w.digest(v) for k, v in model.state_dict().items()} == want["model"]
    assert "fast_rcnn_head.classifier.0.weight" in want["model"]
    state = _empty_state("legacy", 21)
    ck.load_checkpoint(path, state)
    got = state.optimizer.state_dict()["state"]
    assert {i: w.digest(s["momentum_buffer"]) for i, s in got.items()} == want["momentum"]


def test_test_cli_evaluates_a_model_parallel_checkpoint(tp_checkpoints, tmp_path, capsys, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.test import main as test_main

    tmp, _ = tp_checkpoints
    rs = np.random.RandomState(0)
    for split, n in (("VOCtrainval_2007", 1), ("VOCtest_2007", 2)):
        base = tmp_path / split / "VOCdevkit" / "VOC2007"
        (base / "Annotations").mkdir(parents=True)
        (base / "JPEGImages").mkdir(parents=True)
        for i in range(n):
            (base / "Annotations" / f"im{i:03d}.xml").write_text(VOC_XML)
            Image.fromarray(rs.randint(0, 255, (90, 120, 3), dtype=np.uint8)).save(
                base / "JPEGImages" / f"im{i:03d}.jpg"
            )
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    path = str(tmp / "run.orbax.pt")
    argv = ["--data_root", str(tmp_path), "--resize", "64", "--max_size", "96",
            "--dtype", "float32", "--num_workers", "0", "--checkpoint", path]
    assert test_main(argv) == 0
    out = capsys.readouterr().out
    assert f"loaded {path} (epoch 3)" in out and "eval inference: 2 images" in out, out
    assert re.search(r"^mAP = [0-9.]+$", out, re.M), out

"""The port's train CLI (``faster_rcnn_pytorch_tpu_torch.main``) on the CPU.

A tiny VOC tree (4 train and 2 test images, 90x120 px, built as
``tests/test_torch_test_cli.py`` builds its tree) trains at
``--resize 192 --max_size 256 --batch_size 2 --dtype float32``:

* a 2-epoch run prints a loss line per step and an mAP line per epoch
  and, with ``--keep_checkpoints 1``, keeps ``saves/{name}.1.pt`` and the
  ``best`` copy only;
* a 1-epoch run in a subprocess writes ``saves/{name}.0.pt`` and the
  ``best`` copy and never imports jax or flax;
* resuming that run with ``--start_epoch 1 --epoch 2`` ends with
  parameters and optimizer state bit-identical to the 2-epoch run's;
* ``select_device`` raises without a card unless the CPU was asked for,
  and flags of slices not ported yet raise ``NotImplementedError``.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from faster_rcnn_pytorch_tpu_torch.utils import runtime
from tests.test_data import VOC_XML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_train_cli")
    rs = np.random.RandomState(0)
    # Both splits must exist, or the loader tries to download VOC.
    for split, n in (("VOCtrainval_2007", 4), ("VOCtest_2007", 2)):
        base = root / split / "VOCdevkit" / "VOC2007"
        (base / "Annotations").mkdir(parents=True)
        (base / "JPEGImages").mkdir(parents=True)
        for i in range(n):
            (base / "Annotations" / f"im{i:03d}.xml").write_text(VOC_XML)
            img = rs.randint(0, 255, (90, 120, 3), dtype=np.uint8)
            img[20:70, 10:60] = [220, 40, 40]
            Image.fromarray(img).save(base / "JPEGImages" / f"im{i:03d}.jpg")
    return str(root)


def _args(root, log_dir, *extra):
    # multistep: the schedule does not depend on --epoch, so a 1-epoch run
    # and its resume follow the 2-epoch run's learning rates.
    return [
        "--data_root", root, "--resize", "192", "--max_size", "256",
        "--batch_size", "2", "--dtype", "float32", "--num_workers", "0",
        "--log_backend", "csv", "--log_dir", log_dir, "--name", "run",
        "--vis_step", "1", "--lr", "0.001", "--scheduler", "multistep",
        "--milestones", "1", *extra,
    ]


def _saves(log_dir):
    return sorted(os.listdir(os.path.join(log_dir, "run", "saves")))


def _load(log_dir, tag):
    return torch.load(
        os.path.join(log_dir, "run", "saves", f"run.{tag}.pt"), weights_only=True
    )


_MAIN_WITHOUT_JAX = """
import sys
from faster_rcnn_pytorch_tpu_torch.main import main
assert main(sys.argv[1:]) == 0
bad = [m for m in ("jax", "flax") if m in sys.modules]
assert not bad, bad
print("clean")
"""

# A checkpoint of the 21-class model with its momentum is about 1.1 GB, so
# each run's log directory is removed when the module's tests are done.


@pytest.fixture(scope="module")
def one_epoch_run(voc_root, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("logs_resume"))
    env = dict(os.environ, FRT_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN_WITHOUT_JAX, *_args(voc_root, log_dir, "--epoch", "1")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    yield log_dir, proc
    shutil.rmtree(log_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def two_epoch_run(voc_root, tmp_path_factory):
    from faster_rcnn_pytorch_tpu_torch.main import main

    log_dir = str(tmp_path_factory.mktemp("logs_full"))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("FRT_TORCH_DEVICE", "cpu")
        assert main(_args(voc_root, log_dir, "--epoch", "2", "--keep_checkpoints", "1")) == 0
    yield log_dir, out.getvalue()
    shutil.rmtree(log_dir, ignore_errors=True)


def test_one_epoch_run_imports_no_jax_and_saves(one_epoch_run):
    log_dir, proc = one_epoch_run
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]
    assert _saves(log_dir) == ["run.0.pt", "run.best.pt"]
    assert os.path.exists(os.path.join(log_dir, "run", "run_log.csv"))


def test_two_epoch_run_prints_logs_and_prunes(two_epoch_run):
    log_dir, out = two_epoch_run
    losses = [float(m) for m in re.findall(r"\] lr: [0-9.]+ \([0-9.]+\)  loss: ([0-9.]+) ", out)]
    assert len(losses) == 4 and all(np.isfinite(losses)), out
    for epoch in (0, 1):
        assert re.search(rf"^epoch {epoch}: mAP = [0-9.]+$", out, re.M), out
    assert _saves(log_dir) == ["run.1.pt", "run.best.pt"]
    with open(os.path.join(log_dir, "run", "run_log.csv")) as f:
        header, *rows = f.read().splitlines()
    assert "train/loss" in header and "eval/mAP" in header and len(rows) >= 4
    ckpt = _load(log_dir, 1)
    assert ckpt["step"] == 4 and ckpt["metadata"] == {"epoch": 1}


def test_resume_is_bit_identical_to_an_uninterrupted_run(one_epoch_run, two_epoch_run, voc_root, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.main import main

    log_dir, proc = one_epoch_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    resume = ("--start_epoch", "1", "--epoch", "2", "--keep_checkpoints", "1")
    assert main(_args(voc_root, log_dir, *resume)) == 0
    got, want = _load(log_dir, 1), _load(two_epoch_run[0], 1)
    assert got["step"] == want["step"] == 4
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for (i, s), (_, t) in zip(want["optimizer"]["state"].items(), got["optimizer"]["state"].items()):
        assert torch.equal(s["momentum_buffer"], t["momentum_buffer"]), i


def test_select_device_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(runtime.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="FRT_TORCH_DEVICE=cpu"):
        runtime.select_device()
    monkeypatch.setenv(runtime.DEVICE_ENV, "cpu")
    assert runtime.select_device() == torch.device("cpu")
    monkeypatch.setenv(runtime.DEVICE_ENV, "gpu")
    with pytest.raises(ValueError):
        runtime.select_device()


def test_main_without_a_card_raises_before_any_work(monkeypatch, tmp_path):
    from faster_rcnn_pytorch_tpu_torch.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(runtime.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data_root", str(tmp_path / "absent")])


@pytest.mark.parametrize(
    "flags",
    [
        ["--num_devices", "2"],
        ["--coordinator", "localhost:1234"],
        ["--model_parallel", "2"],
        ["--num_hosts", "2"],
        ["--remat_backbone", "true"],
        ["--pretrained_backbone", "vgg.pth"],
        ["--checkpoint", "pretrained"],
        ["--ckpt_backend", "orbax"],
        ["--async_checkpoint", "true"],
    ],
)
def test_flags_of_later_slices_are_refused(flags, tmp_path):
    from faster_rcnn_pytorch_tpu_torch.main import main

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        main(["--data_root", str(tmp_path / "absent"), *flags])

"""The port's train CLI (``faster_rcnn_pytorch_tpu_torch.main``) on the CPU.

A tiny VOC tree (2 train and 2 test images, 90x120 px, built as
``tests/test_torch_test_cli.py`` builds its tree) trains at
``--resize 192 --max_size 256 --batch_size 2 --dtype float32``:

* a 2-epoch run prints a loss line per step and an mAP line per epoch
  and, with ``--keep_checkpoints 1``, keeps ``saves/{name}.1.pt`` and the
  ``best`` copy only;
* a 1-epoch run in a subprocess writes ``saves/{name}.0.pt`` and the
  ``best`` copy and never imports jax or flax;
* resuming that run with ``--start_epoch 1 --epoch 2`` ends with
  parameters and optimizer state bit-identical to the 2-epoch run's;
* the ``test`` CLI with ``--test_epoch best`` and the 2-epoch run's
  ``--log_dir``/``--name`` loads ``saves/run.best.pt`` (its weights reach
  ``evaluate``) and prints the best epoch's detection count and ``mAP =``
  line as ``main`` printed them; a pruned epoch falls back to the seeded
  fresh init with a note naming the missing file; a missing explicit
  ``.pt`` raises in ``test`` and in ``main``, and a ``.ckpt`` raises;
* ``--matmul_precision`` sets the TF32 switches (``high`` on, ``default``
  and ``highest`` off) and any other value raises in both CLIs;
* ``select_device`` raises without a card unless the CPU was asked for.
  (The weight flags, ``--pretrained_backbone`` and ``--checkpoint
  pretrained``, are tested in ``tests/test_torch_pretrained_cli.py``.)
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

from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.utils import runtime
from tests.test_data import VOC_XML
from tests.torch_threads import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_train_cli")
    rs = np.random.RandomState(0)
    # Both splits must exist, or the loader tries to download VOC.
    for split, n in (("VOCtrainval_2007", 2), ("VOCtest_2007", 2)):
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
    env = subprocess_env(FRT_TORCH_DEVICE="cpu")
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
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    for epoch in (0, 1):
        assert re.search(rf"^epoch {epoch}: mAP = [0-9.]+$", out, re.M), out
    assert _saves(log_dir) == ["run.1.pt", "run.best.pt"]
    with open(os.path.join(log_dir, "run", "run_log.csv")) as f:
        header, *rows = f.read().splitlines()
    assert "train/loss" in header and "eval/mAP" in header and len(rows) >= 2
    ckpt = _load(log_dir, 1)
    assert ckpt["step"] == 2 and ckpt["metadata"] == {"epoch": 1}


def test_resume_is_bit_identical_to_an_uninterrupted_run(one_epoch_run, two_epoch_run, voc_root, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.main import main

    log_dir, proc = one_epoch_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    resume = ("--start_epoch", "1", "--epoch", "2", "--keep_checkpoints", "1")
    assert main(_args(voc_root, log_dir, *resume)) == 0
    got, want = _load(log_dir, 1), _load(two_epoch_run[0], 1)
    assert got["step"] == want["step"] == 2
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


def _epoch_evals(out):
    """``{epoch: (detections, "mAP = x")}`` from main's eval lines: each
    epoch line with the detection count of the eval pass before it."""
    evals, detections = {}, None
    for line in out.splitlines():
        if m := re.fullmatch(r"eval inference: .* (\d+) detections above threshold", line):
            detections = int(m.group(1))
        elif m := re.fullmatch(r"epoch (\d+): (mAP = [0-9.]+)", line):
            evals[int(m.group(1))] = (detections, m.group(2))
    return evals


def test_test_cli_scores_the_best_epoch_main_wrote(two_epoch_run, voc_root, capsys, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.engine import evaluate as evaluate_mod
    from faster_rcnn_pytorch_tpu_torch.test import main as test_main

    log_dir, out = two_epoch_run
    evals = _epoch_evals(out)
    assert sorted(evals) == [0, 1], out
    path = os.path.join(log_dir, "run", "saves", "run.best.pt")
    best = torch.load(path, weights_only=True, mmap=True)
    epoch = best["metadata"]["epoch"]
    seen = []
    plain_evaluate = evaluate_mod.evaluate

    def spy(model, *args, **kwargs):
        seen.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        return plain_evaluate(model, *args, **kwargs)

    monkeypatch.setattr(evaluate_mod, "evaluate", spy)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    assert test_main(_args(voc_root, log_dir, "--test_epoch", "best")) == 0
    got = capsys.readouterr().out
    assert f"loaded {path} (epoch {epoch})" in got, got
    for k, v in best["model"].items():
        assert torch.equal(seen[0][k], v), k
    detections, line = evals[epoch]
    assert f" {detections} detections above threshold" in got
    assert re.search(rf"^{re.escape(line)}$", got, re.M), (line, got)


def test_a_test_epoch_without_a_file_takes_the_seeded_init(two_epoch_run):
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, init_weights
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import resolve_and_load_params

    log_dir, _ = two_epoch_run
    opts = load_options(["--log_dir", log_dir, "--name", "run", "--test_epoch", "0", "--seed", "3"])
    model, _ = build_model("legacy", 21)
    note = resolve_and_load_params(opts, model)  # epoch 0 was pruned (--keep_checkpoints 1)
    missing = os.path.join(log_dir, "run", "saves", "run.0.pt")
    assert note == f"no checkpoint at {missing}; fresh init with seed 3"
    want, _ = build_model("legacy", 21)
    init_weights(want, torch.Generator().manual_seed(3))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_a_missing_or_foreign_checkpoint_raises(voc_root, tmp_path, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.main import main as train_main
    from faster_rcnn_pytorch_tpu_torch.test import main as test_main

    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    typo = str(tmp_path / "run.bset.pt")
    with pytest.raises(FileNotFoundError, match="bset"):
        test_main(_args(voc_root, str(tmp_path), "--checkpoint", typo))
    with pytest.raises(ValueError, match=r"\.ckpt"):
        test_main(_args(voc_root, str(tmp_path), "--checkpoint", str(tmp_path / "run.best.ckpt")))
    with pytest.raises(FileNotFoundError):  # before the first epoch
        train_main(_args(voc_root, str(tmp_path), "--epoch", "1", "--checkpoint", typo))
    assert not os.path.exists(os.path.join(str(tmp_path), "run", "saves"))


@pytest.fixture
def tf32_switches():
    """Restore the global TF32 switches a test sets."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


@pytest.mark.parametrize(
    "precision,tf32,mode",
    [("default", False, "highest"), ("highest", False, "highest"), ("high", True, "high")],
)
def test_matmul_precision_sets_the_tf32_switches(tf32_switches, precision, tf32, mode):
    runtime.set_numerics("float32")
    runtime.apply_matmul_precision(precision)
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.get_float32_matmul_precision() == mode


@pytest.mark.parametrize("cli", ["main", "test"])
def test_an_unknown_matmul_precision_is_refused(tf32_switches, cli, tmp_path, monkeypatch):
    import importlib

    main = importlib.import_module(f"faster_rcnn_pytorch_tpu_torch.{cli}").main
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        main(["--data_root", str(tmp_path / "absent"), "--matmul_precision", "bfloat16"])

"""The port's train CLI (``faster_rcnn_pytorch_tpu_torch.main``) on COCO.

A tiny COCO tree (4 train and 2 val images, 80x100 px, 1-2 boxes each
under the raw category ids 1, 3, 18 and 90, both annotation files with
images) trains one epoch of 2 steps at ``--resize 128 --max_size 192
--batch_size 2 --dtype float32`` on the CPU (``FRT_TORCH_DEVICE=cpu``):

* ``--model_generation fpn`` in a subprocess, from a reference-layout
  ``.pth.tar`` (``{"model_state_dict": ...}``) that
  ``load_reference_checkpoint`` reads: a loss line per step, an mAP line
  and the 12 COCO stats, ``saves/run.0.pt`` and ``run.best.pt`` with the
  91-class model, no jax or flax imported. The frozen ``conv1`` leaves the
  epoch as two SGD steps of weight decay alone move it,
  ``(1 - 2.9 a + a^2) p`` with ``a = lr * wd`` (relative 1e-6).
* ``--model_generation legacy`` on the same tree, fresh init: the same
  lines with the 81-class model.
* ``label_offset_for`` reaches the model's config: 0 only for FPN on
  COCO (raw ids), 1 for FPN on VOC and for legacy on either.
* ``--config configs/coco_fpn_train.txt`` parses to the published exp1
  recipe.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = (1, 3, 18, 90)
LR, WD = 0.01, 0.01


def _split(root, split, n, rs):
    (root / split).mkdir()
    images, annotations = [], []
    for i in range(n):
        fname = f"{split}_{i:06d}.jpg"
        img = rs.randint(0, 255, (80, 100, 3), dtype=np.uint8)
        img[10:50, 20:70] = [220, 40, 40]
        Image.fromarray(img).save(root / split / fname)
        images.append({"id": i, "file_name": fname, "width": 100, "height": 80})
        for k in range(1 + i % 2):
            annotations.append(
                {
                    "id": 10 * i + k + 1,
                    "image_id": i,
                    "category_id": CATS[(i + k) % len(CATS)],
                    "bbox": [20 + 10 * k, 10, 50, 40 - 10 * k],
                    "area": 50.0 * (40 - 10 * k),
                    "iscrowd": 0,
                }
            )
    categories = [{"id": c, "name": str(c)} for c in CATS]
    blob = {"images": images, "annotations": annotations, "categories": categories}
    (root / "annotations" / f"instances_{split}.json").write_text(json.dumps(blob))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    # annotations/ must exist, or the loader tries to download COCO
    root = tmp_path_factory.mktemp("coco_train_cli")
    (root / "annotations").mkdir()
    rs = np.random.RandomState(2)
    _split(root, "train2017", 4, rs)
    _split(root, "val2017", 2, rs)
    return str(root)


def _args(root, log_dir, generation, *extra):
    return [
        "--data_type", "coco", "--data_root", root, "--model_generation", generation,
        "--resize", "128", "--max_size", "192", "--batch_size", "2", "--epoch", "1",
        "--dtype", "float32", "--num_workers", "0", "--log_backend", "csv",
        "--log_dir", log_dir, "--name", "run", "--vis_step", "1", "--lr", str(LR),
        "--weight_decay", str(WD), "--scheduler", "multistep", *extra,
    ]


def _check_epoch(log_dir, out, num_classes):
    losses = [float(m) for m in re.findall(r"\] lr: [0-9.]+ \([0-9.]+\)  loss: ([0-9.]+) ", out)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert re.search(r"^epoch 0: mAP = [0-9.]+$", out, re.M), out
    assert len(re.findall(r"^  (AP|AR)[^=]*= -?[0-9.]+$", out, re.M)) == 12, out
    assert sorted(os.listdir(os.path.join(log_dir, "run", "saves"))) == ["run.0.pt", "run.best.pt"]
    ckpt = torch.load(os.path.join(log_dir, "run", "saves", "run.0.pt"), weights_only=True)
    assert ckpt["step"] == 2 and ckpt["metadata"] == {"epoch": 0}
    head = "frcnn_head" if "frcnn_head.cls_head.weight" in ckpt["model"] else "fast_rcnn_head"
    assert ckpt["model"][f"{head}.cls_head.weight"].shape[0] == num_classes
    return ckpt


_MAIN_WITHOUT_JAX = """
import sys
from faster_rcnn_pytorch_tpu_torch.main import main
assert main(sys.argv[1:]) == 0
bad = [m for m in ("jax", "flax") if m in sys.modules]
assert not bad, bad
print("clean")
"""

# A 91-class FPN checkpoint with its momentum is about 330 MB and an
# 81-class legacy one about 1.1 GB: each run's directory goes when done.


@pytest.fixture(scope="module")
def fpn_run(coco_root, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("logs_fpn"))
    model, _ = pfr.build_model("fpn", 91)
    pfr.init_weights(model, torch.Generator().manual_seed(3))
    ckpt = os.path.join(log_dir, "fpn.pth.tar")
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    conv1 = model.backbone.body.conv1.weight.detach().clone()
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN_WITHOUT_JAX, *_args(coco_root, log_dir, "fpn", "--checkpoint", ckpt)],
        cwd=REPO, env=dict(os.environ, FRT_TORCH_DEVICE="cpu"), capture_output=True, text=True,
        timeout=600,
    )
    yield log_dir, proc, conv1
    shutil.rmtree(log_dir, ignore_errors=True)


def test_fpn_coco_run_trains_evaluates_and_saves(fpn_run):
    log_dir, proc, conv1 = fpn_run
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]
    assert "imported torch checkpoint" in proc.stdout
    ckpt = _check_epoch(log_dir, proc.stdout, 91)
    # conv1 is frozen: zero gradients, so two steps of decay and momentum
    a = LR * WD
    got = ckpt["model"]["backbone.body.conv1.weight"]
    assert not torch.equal(got, conv1)
    torch.testing.assert_close(got, conv1 * (1 - 2.9 * a + a * a), rtol=1e-6, atol=1e-9)


def test_legacy_coco_run_trains_evaluates_and_saves(coco_root, tmp_path):
    from faster_rcnn_pytorch_tpu_torch.main import main

    log_dir = str(tmp_path / "logs_legacy")
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
            mp.setenv("FRT_TORCH_DEVICE", "cpu")
            assert main(_args(coco_root, log_dir, "legacy")) == 0
        _check_epoch(log_dir, out.getvalue(), 81)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


class _Built(Exception):
    pass


@pytest.mark.parametrize(
    "generation,data_type,offset",
    [("fpn", "coco", 0), ("fpn", "voc", 1), ("legacy", "voc", 1), ("legacy", "coco", 1)],
)
def test_label_offset_reaches_the_config(generation, data_type, offset, monkeypatch, tmp_path):
    from faster_rcnn_pytorch_tpu_torch.data import loader
    from faster_rcnn_pytorch_tpu_torch.main import main

    seen = {}

    def build_model(*args, **kwargs):
        seen["cfg"] = pfr.build_model.__wrapped__(*args, **kwargs)[1]
        raise _Built

    build_model.__wrapped__ = pfr.build_model
    monkeypatch.setattr(pfr, "build_model", build_model)
    monkeypatch.setattr(loader, "build_dataloader", lambda opts: (None, None))  # no data, no download
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    with pytest.raises(_Built):
        main(["--model_generation", generation, "--data_type", data_type, "--data_root", str(tmp_path)])
    assert seen["cfg"].label_offset == offset


def test_published_fpn_recipe_parses():
    from faster_rcnn_pytorch_tpu_torch.config import load_options

    opts = load_options(["--config", os.path.join(REPO, "configs", "coco_fpn_train.txt")])
    assert (opts.model_generation, opts.data_type, opts.batch_size, opts.epoch) == ("fpn", "coco", 4, 26)
    assert (opts.lr, opts.weight_decay, opts.scheduler) == (2e-3, 1e-4, "multistep")
    assert tuple(opts.milestones) == (16, 22)

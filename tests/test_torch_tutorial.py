"""The port's single-image tutorial (``examples/tutorial_torch.py``)
against the JAX tutorial's steps (``examples/tutorial.py``).

On one seeded JPEG and one JAX-written ``.pth.tar``, with the min side
set to 64 and float32 weights, the tutorial's canvas equals the JAX
steps' (``resize_min_side``, ``normalize``, the /16 canvas) bit for bit,
and its canvas -> ``predict`` -> original-pixel detections agree with
``model.apply(..., method=predict)`` rescaled as the JAX tutorial does,
under the greedy match of test_torch_legacy_predict (label, IoU >= 0.99,
99% matched, score and box |d| <= 1e-4 canvas units). The threshold is
set to 0.01 for that comparison: the JAX init's class scores sit near
1/21, under the tutorial's 0.5. Then ``main`` on the CPU writes
``tutorial_out.png`` with OpenCV, matplotlib not needed, and without a
card and without ``FRT_TORCH_DEVICE=cpu`` it raises.
"""

import importlib.util
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from faster_rcnn_pytorch_tpu.data.loader import load_image as jax_load_image
from faster_rcnn_pytorch_tpu.data.transforms import normalize, resize_min_side
from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.utils.checkpoint import (
    import_legacy_torch_params,
    load_torch_state_dict,
    save_torch_checkpoint,
)
from faster_rcnn_pytorch_tpu_torch.data.loader import load_image
from faster_rcnn_pytorch_tpu_torch.utils.runtime import prepare_for_inference, set_numerics
from tests.test_torch_legacy_predict import assert_detections_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SIDE = 64
THRESHOLD = 0.01


def _load_tutorial():
    spec = importlib.util.spec_from_file_location(
        "tutorial_torch", os.path.join(REPO, "examples", "tutorial_torch.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jpeg_and_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("tutorial")
    img = np.random.RandomState(0).randint(0, 255, (90, 120, 3), dtype=np.uint8)
    img[20:70, 10:60] = [220, 40, 40]
    jpeg = str(root / "x.jpg")
    Image.fromarray(img).save(jpeg)
    model, _ = jfr.build_model("legacy", num_classes=21, dtype=jnp.float32)
    ckpt = str(root / "frcnn.best.pth.tar")
    save_torch_checkpoint(ckpt, jfr.init_detector_params(model, jax.random.key(3), canvas=64), "legacy")
    yield jpeg, ckpt
    shutil.rmtree(root, ignore_errors=True)  # the checkpoint is about 1 GB


@pytest.fixture
def tutorial(monkeypatch):
    module = _load_tutorial()
    monkeypatch.setattr(module, "MIN_SIDE", MIN_SIDE)
    return module


def _jax_tutorial_steps(jpeg, ckpt):
    """examples/tutorial.py's steps 2-3 in float32 at ``MIN_SIDE`` and
    ``THRESHOLD``: (canvas, detections in original pixels)."""
    model, cfg = jfr.build_model("legacy", num_classes=21, dtype=jnp.float32)
    params = import_legacy_torch_params(load_torch_state_dict(ckpt), 21)
    raw = jax_load_image(jpeg)
    resized, _ = resize_min_side(raw, np.zeros((0, 4), np.float32), MIN_SIDE)
    h, w = resized.shape[:2]
    ch, cw = -(-h // 16) * 16, -(-w // 16) * 16
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:h, :w] = normalize(resized)
    extent = np.array([[w / cw, h / ch]], np.float32)
    det = jax.jit(lambda p, im, e: model.apply(p, cfg, im, e, THRESHOLD, method=jfr.predict))(
        params, jnp.asarray(canvas[None]), jnp.asarray(extent)
    )
    valid = np.asarray(det.valid[0])
    boxes = np.asarray(det.boxes[0])[valid] * np.array([cw, ch, cw, ch])
    boxes = boxes / np.array([w, h, w, h]) * np.array([raw.shape[1], raw.shape[0]] * 2)
    dets = {"boxes": boxes, "labels": np.asarray(det.labels[0])[valid], "scores": np.asarray(det.scores[0])[valid]}
    return canvas, dets


def test_tutorial_step_matches_jax(tutorial, jpeg_and_checkpoint, monkeypatch):
    monkeypatch.setattr(tutorial, "THRESHOLD", THRESHOLD)
    jpeg, ckpt = jpeg_and_checkpoint
    want_canvas, want = _jax_tutorial_steps(jpeg, ckpt)

    raw = load_image(jpeg)
    canvas, extent, (h, w) = tutorial.to_canvas(raw)
    np.testing.assert_array_equal(canvas, want_canvas)
    model, cfg = tutorial.load_model(ckpt)
    model = prepare_for_inference(model, torch.device("cpu"), set_numerics("float32"))
    boxes, labels, scores = tutorial.detect_image(model, cfg, raw)

    assert len(scores) == len(want["scores"]) > 0
    ch, cw = canvas.shape[:2]
    box_tol = 1e-4 * max(cw * raw.shape[1] / w, ch * raw.shape[0] / h)
    assert_detections_match({"boxes": boxes, "labels": labels, "scores": scores}, want, box_tol=box_tol)


def test_main_on_the_cpu_writes_the_drawing(tutorial, jpeg_and_checkpoint, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    jpeg, ckpt = jpeg_and_checkpoint
    assert tutorial.main([jpeg, ckpt]) == 0
    out = capsys.readouterr().out
    assert f"imported torch checkpoint {ckpt}" in out
    assert re.search(r"^\d+ detections$", out, re.M), out
    assert os.path.getsize(tmp_path / "tutorial_out.png") > 0


def test_draw_without_matplotlib(tutorial, tmp_path, monkeypatch):
    """The drawing takes OpenCV alone: it is made with matplotlib hidden."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # its import raises ImportError
    raw = np.full((60, 80, 3), 128, np.uint8)
    path = str(tmp_path / "out.png")
    tutorial.draw(raw, np.array([[5.0, 5.0, 40.0, 30.0]]), np.array([6]), np.array([0.9]), path)
    drawn = np.asarray(Image.open(path))
    assert drawn.shape == raw.shape and (drawn != 128).any()


def test_main_needs_a_card_or_the_cpu_choice(tutorial, monkeypatch):
    monkeypatch.delenv("FRT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="FRT_TORCH_DEVICE=cpu"):
        tutorial.main([])

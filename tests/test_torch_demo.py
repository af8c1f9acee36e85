"""The port's demo CLI (``demo.py``, ``engine/demo.py``) against the JAX
package's ``engine.demo.demo`` on the same weights, on the CPU.

The JAX package's ``init_detector_params`` weights (VGG16, VOC's 21
classes) go to a reference ``.pth.tar`` through its
``save_torch_checkpoint``; the port's CLI imports that file
(``--checkpoint``) under ``FRT_TORCH_DEVICE=cpu``. Two seeded JPEGs of odd
sizes (each padded to its /64-aligned canvas) at threshold 0.03 (random
weights over 21 classes sit near 1/21), float32.
Per image: the same output line apart from timing, and the detections
(original pixels) greedy-matched by label and IoU >= 0.99, 99% matched,
score ``|d| <= 1e-4`` and box ``|d| <= 1e-4`` of the canvas side
(``tests/test_torch_legacy_predict.py``'s tolerance in canvas units).
"""

import importlib.util
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faster_rcnn_pytorch_tpu import config as jconfig
from faster_rcnn_pytorch_tpu.engine.demo import demo as jax_demo
from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.utils.checkpoint import save_torch_checkpoint
from faster_rcnn_pytorch_tpu_torch import demo as port_demo_cli
from faster_rcnn_pytorch_tpu_torch.engine import demo as port_engine
from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils.runtime import DEVICE_ENV

SIZES = ((70, 100), (90, 60))  # canvases 128x128 and 128x64


@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("demo")
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate(SIZES):
        img = rs.randint(0, 255, (h, w, 3), np.uint8)
        img[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = (220, 40, 40)
        Image.fromarray(img).save(os.path.join(root, f"im{i}.jpg"), quality=95)
    model, cfg = jfr.build_model("legacy", num_classes=21, dtype=jnp.float32, label_offset=1)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(model, jax.random.key(0), canvas=64))
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    ckpt = os.path.join(ckpt_dir, "jax.pth.tar")
    save_torch_checkpoint(ckpt, params, "legacy")
    yield str(root), ckpt, model, cfg, params
    shutil.rmtree(ckpt_dir, ignore_errors=True)  # a 0.5 GB weights file


def _argv(root, *extra):
    return ["--data_type", "voc", "--demo_root", root, "--dtype", "float32", "--thres", "0.03", *extra]


def _lines(out):
    return [line for line in out.splitlines() if re.match(r"im\d\.jpg: ", line)]


def test_demo_cli_matches_jax_demo(demo_setup, capsys, monkeypatch):
    root, ckpt, jmodel, jcfg, params = demo_setup
    want = jax_demo(jmodel, jcfg, params, jconfig.load_options(_argv(root, "--demo_vis", "false")))
    want_lines = _lines(capsys.readouterr().out)

    got = []
    real = port_engine.demo
    monkeypatch.setattr(port_engine, "demo", lambda *a: got.extend(real(*a)) or got)
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert port_demo_cli.main(_argv(root, "--checkpoint", ckpt)) == 0
    out = capsys.readouterr().out
    assert f"imported torch checkpoint {ckpt}" in out
    assert "demo done: 2 images" in out
    assert _lines(out) == want_lines and len(want_lines) == 2

    assert [r["path"] for r in got] == [r["path"] for r in want]
    for g, w, (h, wd) in zip(got, want, SIZES):
        assert len(w["scores"]) > 0, "no detections to compare"
        side = max(-(-h // 64), -(-wd // 64)) * 64
        ok, summary = detections_agree(
            {k: np.asarray(g[k]) for k in ("boxes", "labels", "scores")},
            {k: np.asarray(w[k]) for k in ("boxes", "labels", "scores")},
            score_tol=1e-4,
            box_tol=1e-4 * side,
        )
        assert ok, summary
        assert (g["boxes"][:, [0, 2]] <= wd).all() and (g["boxes"][:, [1, 3]] <= h).all()
    # with OpenCV the drawn images are written, without it nothing is
    drawn = sorted(os.listdir(os.path.join(root, "detection_results")))
    assert drawn == (["im0.jpg", "im1.jpg"] if importlib.util.find_spec("cv2") else [])


def test_pad_to_bucket_equals_jax():
    from faster_rcnn_pytorch_tpu.engine.demo import _pad_to_bucket

    rs = np.random.RandomState(1)
    for h, w in ((70, 100), (64, 64), (1, 129)):
        img = rs.randint(0, 255, (h, w, 3), np.uint8)
        got, want = port_engine.pad_to_bucket(img), _pad_to_bucket(img)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_device_anchors_keep_only_the_last_canvases():
    """The demo pads each image to its own canvas: the model keeps the
    anchors of the last ``ANCHOR_CACHE_SIZE`` canvases only, and a hit
    returns the kept tensor and makes it the newest."""
    model, _ = pfr.build_model("legacy", 21)
    canvases = [(64 * (i + 1), 64) for i in range(pfr.ANCHOR_CACHE_SIZE + 2)]
    for h, w in canvases:
        got = pfr.device_anchors(model, h, w, "cpu")
        np.testing.assert_array_equal(got.numpy(), model.canvas_anchors(h, w))
    kept = [(h, w, "cpu") for h, w in canvases[-pfr.ANCHOR_CACHE_SIZE :]]
    assert list(model._device_anchors) == kept
    oldest = kept[0]
    assert pfr.device_anchors(model, *oldest) is model._device_anchors[oldest]
    assert list(model._device_anchors) == kept[1:] + [oldest]

"""The port's ``test`` CLI against the JAX ``test`` CLI on a 20-class set.

``tests/test_torch_test_cli.py`` holds the two CLIs together on a tiny
tree with one class. Here the set covers the whole VOC class universe:
``tools/make_shapes_voc.py::write_split(..., classes20=True)`` writes 24
test scenes whose first objects carry classes 0..19 in turn (4 shapes x
5 colours on all 20 VOC names), beside a small train split (the loader
needs both splits). Each generation gets one reference-layout
``.pth.tar`` from the JAX package's ``save_torch_checkpoint`` of seeded
``init_detector_params``, and both CLIs run in-process on it at
``--resize 128 --max_size 192 --dtype float32 --thres 0.01``:

* the same detection count;
* every image's detections greedy-matched as in
  ``tests/test_torch_legacy_predict.py`` (label, IoU >= 0.99, 99%
  paired, score |d| <= 1e-4, box |d| <= 1e-4 canvas units in pixels of
  the 320-px scenes);
* each of the 20 per-class APs and the mAP, as each CLI prints them
  (4 decimals), within 1e-4.
"""

import os
import pickle
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faster_rcnn_pytorch_tpu.models.faster_rcnn import build_model, init_detector_params
from faster_rcnn_pytorch_tpu.utils.checkpoint import save_torch_checkpoint
from tests.test_torch_legacy_predict import assert_detections_match
from tests.test_torch_test_cli import _parse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_shapes_voc import CLASSES20, SIZE, write_split  # noqa: E402

RESIZE, MAX_SIZE = 128, 192
# 1e-4 canvas units in pixels of the scenes: a square scene fills
# RESIZE x RESIZE of the RESIZE x MAX_SIZE canvas
BOX_TOL_PX = 1e-4 * MAX_SIZE * SIZE / RESIZE
AP_LINE = re.compile(r"^\s+(\w+)\s+AP = ([0-9.]+|nan)$", re.M)


@pytest.fixture(scope="module")
def shapes20(tmp_path_factory):
    """The 20-class tree: 24 test scenes (every VOC name present) and 4
    train scenes; removed with the checkpoints when the module is done."""
    root = tmp_path_factory.mktemp("shapes20_cli")
    write_split(str(root / "VOCtest_2007" / "VOCdevkit" / "VOC2007"), n=24, seed=3, classes20=True)
    write_split(str(root / "VOCtrainval_2007" / "VOCdevkit" / "VOC2007"), n=4, seed=0, classes20=True)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _args(root, generation, ckpt, dump):
    return [
        "--data_type", "voc", "--data_root", str(root), "--model_generation", generation,
        "--num_classes", "21", "--resize", str(RESIZE), "--max_size", str(MAX_SIZE),
        "--dtype", "float32", "--thres", "0.01", "--num_workers", "0", "--num_devices", "1",
        "--checkpoint", ckpt, "--dump_detections", dump,
    ]


def _class_aps(out: str) -> dict:
    aps = dict(AP_LINE.findall(out))
    assert set(aps) == set(CLASSES20), sorted(aps)
    return {k: float(v) for k, v in aps.items()}


@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_port_cli_matches_jax_cli_on_20_classes(shapes20, generation, tmp_path, capsys, monkeypatch):
    import faster_rcnn_pytorch_tpu.utils.runtime as jax_runtime
    from faster_rcnn_pytorch_tpu.test import main as jax_main
    from faster_rcnn_pytorch_tpu_torch.test import main as port_main

    # keep the test session's jax compile-cache settings
    monkeypatch.setattr(jax_runtime, "setup_runtime", lambda: None)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    model, _ = build_model(generation, num_classes=21, dtype=jnp.float32)
    ckpt = str(tmp_path / f"{generation}.pth.tar")
    save_torch_checkpoint(ckpt, init_detector_params(model, jax.random.key(5), canvas=64), generation)
    jax_dump, port_dump = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")

    assert jax_main(_args(shapes20, generation, ckpt, jax_dump)) == 0
    jax_out = capsys.readouterr().out
    assert port_main(_args(shapes20, generation, ckpt, port_dump)) == 0
    port_out = capsys.readouterr().out
    os.remove(ckpt)  # up to 1 GB, read by both CLIs
    assert "imported torch checkpoint" in port_out

    j_imgs, j_dets, j_map = _parse(jax_out)
    p_imgs, p_dets, p_map = _parse(port_out)
    assert (p_imgs, p_dets) == (j_imgs, j_dets) and j_imgs == 24 and j_dets > 0
    assert abs(p_map - j_map) <= 1e-4, (p_map, j_map)
    j_aps, p_aps = _class_aps(jax_out), _class_aps(port_out)
    assert {k: v for k, v in p_aps.items() if abs(v - j_aps[k]) > 1e-4} == {}, (p_aps, j_aps)

    with open(jax_dump, "rb") as f:
        want = pickle.load(f)
    with open(port_dump, "rb") as f:
        got = pickle.load(f)
    assert set(got["predictions"]) == set(want["predictions"])
    labels = set()
    for img_id, p in got["predictions"].items():
        assert_detections_match(p, want["predictions"][img_id], box_tol=BOX_TOL_PX)
        np.testing.assert_array_equal(got["gts"][img_id]["boxes"], want["gts"][img_id]["boxes"])
        labels |= set(np.asarray(got["gts"][img_id]["labels"]).tolist())
    assert labels == set(range(20))  # every VOC class has gt in the set

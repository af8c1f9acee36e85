"""The port's ``test`` CLI against the JAX ``test`` CLI on one checkpoint.

Both CLIs run in-process on a tiny VOC tree with the same reference-layout
``.pth.tar`` (written by ``save_torch_checkpoint``) at
``--resize 64 --max_size 96 --dtype float32 --thres 0.01``, and dump their
detections. They must report the same detection count and agree under the
greedy match of test_torch_legacy_predict (label, IoU >= 0.99, 99% matched,
score |d| <= 1e-4, box |d| <= 1e-4 canvas units, which is at most 0.018 px
of these 120-px-wide images).

A subprocess checks that the port's predict path leaves jax, flax and
Pillow unimported (this process has jax loaded by conftest).
"""

import os
import pickle
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from faster_rcnn_pytorch_tpu.models.faster_rcnn import build_model, init_detector_params
from faster_rcnn_pytorch_tpu.utils.checkpoint import save_torch_checkpoint
from tests.test_data import VOC_XML
from tests.test_torch_legacy_predict import assert_detections_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_TOL_PX = 1e-4 * 1.5 * 120


@pytest.fixture(scope="module")
def voc_and_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_cli")
    rs = np.random.RandomState(0)
    # Both splits must exist, or the loader tries to download VOC.
    for split, n in (("VOCtrainval_2007", 2), ("VOCtest_2007", 3)):
        base = root / split / "VOCdevkit" / "VOC2007"
        (base / "Annotations").mkdir(parents=True)
        (base / "JPEGImages").mkdir(parents=True)
        for i in range(n):
            (base / "Annotations" / f"im{i:03d}.xml").write_text(VOC_XML)
            img = rs.randint(0, 255, (90, 120, 3), dtype=np.uint8)
            img[20:70, 10:60] = [220, 40, 40]
            Image.fromarray(img).save(base / "JPEGImages" / f"im{i:03d}.jpg")
    model, _ = build_model("legacy", num_classes=21, dtype=jnp.float32)
    params = init_detector_params(model, jax.random.key(3), canvas=64)
    ckpt = str(root / "legacy.pth.tar")
    save_torch_checkpoint(ckpt, params, "legacy")
    yield str(root), ckpt
    shutil.rmtree(root, ignore_errors=True)  # the 0.98 GB checkpoint


def _args(root, ckpt, dump):
    return [
        "--data_type", "voc", "--data_root", root, "--resize", "64",
        "--max_size", "96", "--dtype", "float32", "--thres", "0.01",
        "--num_workers", "0", "--num_devices", "1", "--checkpoint", ckpt,
        "--dump_detections", dump,
    ]


def _parse(out):
    m = re.search(r"eval inference: (\d+) images .* (\d+) detections above threshold", out)
    assert m, out
    ap = re.search(r"^mAP = ([0-9.]+)$", out, re.M)
    assert ap, out
    return int(m.group(1)), int(m.group(2)), float(ap.group(1))


def test_port_cli_matches_jax_cli(voc_and_checkpoint, tmp_path, capsys, monkeypatch):
    import faster_rcnn_pytorch_tpu.utils.runtime as jax_runtime
    from faster_rcnn_pytorch_tpu.test import main as jax_main
    from faster_rcnn_pytorch_tpu_torch.test import main as port_main

    # keep the test session's jax compile-cache settings
    monkeypatch.setattr(jax_runtime, "setup_runtime", lambda: None)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    root, ckpt = voc_and_checkpoint
    jax_dump, port_dump = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")

    assert jax_main(_args(root, ckpt, jax_dump)) == 0
    jax_out = capsys.readouterr().out
    assert port_main(_args(root, ckpt, port_dump)) == 0
    port_out = capsys.readouterr().out
    assert "imported torch checkpoint" in port_out

    j_imgs, j_dets, j_map = _parse(jax_out)
    p_imgs, p_dets, p_map = _parse(port_out)
    assert (p_imgs, p_dets) == (j_imgs, j_dets) and j_imgs == 3 and j_dets > 0
    assert abs(p_map - j_map) <= 1e-3

    with open(jax_dump, "rb") as f:
        want = pickle.load(f)
    with open(port_dump, "rb") as f:
        got = pickle.load(f)
    assert set(got["predictions"]) == set(want["predictions"])
    for img_id, p in got["predictions"].items():
        assert_detections_match(p, want["predictions"][img_id], box_tol=BOX_TOL_PX)
        np.testing.assert_array_equal(got["gts"][img_id]["boxes"], want["gts"][img_id]["boxes"])


_PREDICT_WITHOUT_JAX = """
import sys
import numpy as np
import torch
import faster_rcnn_pytorch_tpu_torch.test
from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, init_weights, predict
from faster_rcnn_pytorch_tpu_torch.utils.convert import legacy_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import prepare_for_inference, set_numerics

model, cfg = build_model("legacy", num_classes=6)
init_weights(model, torch.Generator().manual_seed(0))
model = prepare_for_inference(model, torch.device("cpu"), set_numerics("float32"))
images = torch.tensor(np.random.RandomState(0).normal(size=(1, 64, 64, 3)).astype(np.float32))
det = predict(model, cfg, images, torch.ones(1, 2), 0.05)
assert det.boxes.shape == (1, 100, 4), det.boxes.shape
bad = [m for m in ("jax", "flax", "PIL") if m in sys.modules]
assert not bad, bad
print("clean")
"""


def test_port_predict_imports_no_jax_flax_or_pillow():
    proc = subprocess.run(
        [sys.executable, "-c", _PREDICT_WITHOUT_JAX],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-2000:]

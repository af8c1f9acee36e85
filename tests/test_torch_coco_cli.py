"""The port's ``test`` CLI on COCO against the JAX ``test`` CLI.

Both CLIs run in-process on a tiny COCO tree (val2017 images with their
``instances_val2017.json``, and an empty train split the loader also
reads) with one reference-layout ``.pth.tar`` written by
``save_torch_checkpoint``, at ``--resize 128 --max_size 192 --dtype
float32``: every FPN level is at least 4 cells, so the JAX package takes
its main CPU align path. Cases:

* ``--model_generation fpn --num_classes 91``, full FPN_CONFIG budgets.
  The JAX init's class head is N(0, 0.01), which leaves every class near
  1/91; it is scaled before saving (``KERNEL_SCALES``), so the top
  classes clear the 0.05 threshold with distinct scores.
* ``--model_generation legacy`` on the same tree (81 classes): its labels
  go through COCO's contiguous-to-category table.

They must report the same image and detection counts, |mAP| within 1e-3,
and detection dumps that agree under the greedy match of
test_torch_legacy_predict (box tolerance 1e-4 canvas units, at most
0.016 px of these 100-px images). A subprocess runs the port's FPN
predict through its CLI and checks that jax and flax stay unimported.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from faster_rcnn_pytorch_tpu.models.faster_rcnn import build_model, init_detector_params
from faster_rcnn_pytorch_tpu.utils.checkpoint import save_torch_checkpoint
from tests.test_torch_legacy_predict import assert_detections_match
from tests.test_torch_test_cli import _parse
from tests.torch_threads import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = (1, 3, 18, 90)
BOX_TOL_PX = 1e-4 * 1.6 * 100


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_cli")
    (root / "val2017").mkdir()
    (root / "annotations").mkdir()
    rs = np.random.RandomState(1)
    images, annotations = [], []
    for i in range(3):
        fname = f"{i:012d}.jpg"
        img = rs.randint(0, 255, (80, 100, 3), dtype=np.uint8)
        img[10:50, 20:70] = [220, 40, 40]
        Image.fromarray(img).save(root / "val2017" / fname)
        images.append({"id": i, "file_name": fname, "width": 100, "height": 80})
        for k in range(2):
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
    val = {"images": images, "annotations": annotations, "categories": categories}
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps(val))
    train = {"images": [], "annotations": [], "categories": categories}
    (root / "annotations" / "instances_train2017.json").write_text(json.dumps(train))
    return str(root)


# Kernel scales per generation and parameter subtree: enough for distinct
# top scores above the 0.05 threshold at 91 (fpn) and 81 (legacy) classes.
# The legacy VGG16 at the JAX init's LeCun scale shrinks its activations
# by sqrt(2) per ReLU layer; sqrt(2) makes it He-scaled.
KERNEL_SCALES = {
    "fpn": {"cls_head": 5.0},
    "legacy": {"extractor": 2**0.5, "fc6": 2**0.5, "fc7": 2**0.5, "cls_head": 2.0},
}


def _checkpoint(root, generation, num_classes, seed):
    model, _ = build_model(generation, num_classes=num_classes, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, init_detector_params(model, jax.random.key(seed), canvas=64))
    p = params["params"]
    for name, scale in KERNEL_SCALES[generation].items():
        p[name] = jax.tree_util.tree_map_with_path(
            lambda path, a: a * scale if path[-1].key == "kernel" else a, p[name]
        )
    path = os.path.join(root, f"{generation}.pth.tar")
    save_torch_checkpoint(path, params, generation)
    return path


def _args(root, generation, ckpt, dump):
    return [
        "--data_type", "coco", "--data_root", root, "--model_generation", generation,
        "--num_classes", "91" if generation == "fpn" else "81", "--resize", "128",
        "--max_size", "192", "--dtype", "float32", "--thres", "0.05", "--num_workers", "0",
        "--num_devices", "1", "--checkpoint", ckpt, "--dump_detections", dump,
    ]


@pytest.mark.parametrize("generation", ["fpn", "legacy"])
def test_port_coco_cli_matches_jax_cli(coco_root, generation, tmp_path, capsys, monkeypatch):
    import faster_rcnn_pytorch_tpu.utils.runtime as jax_runtime
    from faster_rcnn_pytorch_tpu.test import main as jax_main
    from faster_rcnn_pytorch_tpu_torch.test import main as port_main

    monkeypatch.setattr(jax_runtime, "setup_runtime", lambda: None)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    ckpt = _checkpoint(str(tmp_path), generation, 91 if generation == "fpn" else 81, seed=6)
    jax_dump, port_dump = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")

    assert jax_main(_args(coco_root, generation, ckpt, jax_dump)) == 0
    jax_out = capsys.readouterr().out
    assert port_main(_args(coco_root, generation, ckpt, port_dump)) == 0
    port_out = capsys.readouterr().out
    os.remove(ckpt)  # up to 1 GB, read by both CLIs
    assert "imported torch checkpoint" in port_out

    j_imgs, j_dets, j_map = _parse(jax_out)
    p_imgs, p_dets, p_map = _parse(port_out)
    assert (p_imgs, p_dets) == (j_imgs, j_dets) and j_imgs == 3 and j_dets > 0
    assert abs(p_map - j_map) <= 1e-3

    with open(jax_dump, "rb") as f:
        want = pickle.load(f)["predictions"]
    with open(port_dump, "rb") as f:
        got = pickle.load(f)["predictions"]
    assert set(got) == set(want)
    for img_id, p in got.items():
        assert_detections_match(p, want[img_id], box_tol=BOX_TOL_PX)
        # labels are dataset category ids, not the head's class indices:
        # fpn's softmax index + 1; legacy's through contiguous_to_cat, with
        # -1 for the model's slots past the tree's four categories
        want_ids = set(range(1, 91)) if generation == "fpn" else set(CATS) | {-1}
        assert set(p["labels"].tolist()) <= want_ids


_FPN_CLI_WITHOUT_JAX = """
import sys
from faster_rcnn_pytorch_tpu_torch.test import main
assert main(sys.argv[1:]) == 0
bad = [m for m in ("jax", "flax") if m in sys.modules]
assert not bad, bad
print("clean")
"""


def test_port_fpn_cli_imports_no_jax_or_flax(coco_root, tmp_path):
    args = _args(coco_root, "fpn", "", str(tmp_path / "d.pkl"))
    args = args[: args.index("--checkpoint")] + ["--dump_detections", str(tmp_path / "d.pkl")]
    proc = subprocess.run(
        [sys.executable, "-c", _FPN_CLI_WITHOUT_JAX, *args],
        cwd=REPO,
        env=subprocess_env(FRT_TORCH_DEVICE="cpu"),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-2000:]
    assert "fresh init with seed 0" in proc.stdout

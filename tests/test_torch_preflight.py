"""The port's real-data drill
(``faster_rcnn_pytorch_tpu_torch/tools/preflight_real_data.py``) against
the JAX package's (``tools/preflight_real_data.py``).

The nine cases of ``tests/test_preflight.py`` on the same synthetic trees,
each through both drills: the same layout reports and census
(``torch_keys``, ``params``) on one JAX-written ``.pth.tar``, and the same
``SystemExit`` text up to file references. Then the bounded eval: on a
3-image VOC tree with that checkpoint at ``--resize 64 --max_size 96
--dtype float32 --num_workers 0 --thres 0.01`` and
``FRT_PREFLIGHT_LIMIT=2``, both
``run_mini_eval`` take the same images and detection count, their mAPs
agree within 1e-3 and their detections under the greedy match of
test_torch_legacy_predict (label, IoU >= 0.99, 99% matched, score and box
|d| <= 1e-4 canvas units); the same on the 3-image COCO tree with a
JAX-written 81-class checkpoint and ``--num_classes 81``. The port's ``main`` end to end on that tree
and, with no checkpoint, on the COCO tree with the FPN generation; and
without a card and without ``FRT_TORCH_DEVICE=cpu`` it raises.
"""

import json
import os
import pickle
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tools.preflight_real_data as jax_drill
from faster_rcnn_pytorch_tpu.models.faster_rcnn import build_model, init_detector_params
from faster_rcnn_pytorch_tpu.utils.checkpoint import save_torch_checkpoint
from faster_rcnn_pytorch_tpu_torch.tools import preflight_real_data as port_drill
from tests.test_preflight import _make_coco_tree, _make_voc_tree
from tests.test_torch_legacy_predict import assert_detections_match

LIMIT = 2
# 1e-4 canvas units in original pixels (the 96-px canvas holds the 85-px
# resize of the 120-px-wide images)
BOX_TOL_PX = 1e-4 * 96 * 120 / 85


def _eval_args(root, ckpt, data_type="voc"):
    # --thres 0.01: the JAX init's class scores sit near 1/21 (1/81 on
    # COCO), under the default 0.05, and the comparison needs detections
    return [
        "--data_type", data_type, "--data_root", root, "--checkpoint", ckpt,
        "--resize", "64", "--max_size", "96", "--dtype", "float32", "--num_workers", "0",
        "--thres", "0.01",
    ] + (["--num_classes", "81"] if data_type == "coco" else [])


def _tree_and_checkpoint(tmp_path_factory, data_type):
    """A 3-image tree of ``data_type`` and a JAX-written legacy
    ``.pth.tar`` of its class count (21 or 81) beside it."""
    root = tmp_path_factory.mktemp(f"preflight_{data_type}")
    num_classes = 21 if data_type == "voc" else 81
    (_make_voc_tree if data_type == "voc" else _make_coco_tree)(root)
    model, _ = build_model("legacy", num_classes=num_classes, dtype=jnp.float32)
    params = init_detector_params(model, jax.random.key(3), canvas=64)
    ckpt = str(root / "frcnn.best.pth.tar")
    save_torch_checkpoint(ckpt, params, "legacy")
    if data_type == "coco":
        # The tree's one category (contiguous 0, softmax slot 1) lifted over
        # the rest, and its val boxes grown to the size of the untrained
        # model's boxes (near the whole image at this canvas): detections
        # carry the category through the label map and the COCO score has
        # true positives to count
        blob = torch.load(ckpt, weights_only=True)
        blob["model_state_dict"]["fast_rcnn_head.cls_head.bias"][1] += 2.0
        torch.save(blob, ckpt)
        ann_path = root / "annotations" / "instances_val2017.json"
        ann = json.loads(ann_path.read_text())
        for a in ann["annotations"]:
            a["bbox"], a["area"] = [2, 2, 96, 76], 96 * 76
        ann_path.write_text(json.dumps(ann))
    yield str(root), ckpt
    shutil.rmtree(root, ignore_errors=True)  # the checkpoint is about 1 GB


@pytest.fixture(scope="module")
def voc_and_checkpoint(tmp_path_factory):
    yield from _tree_and_checkpoint(tmp_path_factory, "voc")


@pytest.fixture(scope="module")
def coco_and_checkpoint(tmp_path_factory):
    yield from _tree_and_checkpoint(tmp_path_factory, "coco")


def _exit_text(fn, *args) -> str:
    """``fn``'s SystemExit text, its file references dropped."""
    with pytest.raises(SystemExit) as err:
        fn(*args)
    return re.sub(r"\s*\([^()]*\.(py|md):[\d-]+[^()]*\)", "", str(err.value))


def _both_exit(name, *args, match=""):
    want = _exit_text(getattr(jax_drill, name), *args)
    got = _exit_text(getattr(port_drill, name), *args)
    assert got == want and re.search(match, got), (got, want)


def test_voc_layout_pass(tmp_path):
    _make_voc_tree(tmp_path)
    report = port_drill.check_voc_layout(str(tmp_path))
    assert report == jax_drill.check_voc_layout(str(tmp_path))
    assert report["trainval"]["images"] == 3
    assert report["test"]["images"] == 3


def test_voc_layout_missing_test_split(tmp_path):
    _make_voc_tree(tmp_path, splits=("VOCtrainval_2007",))
    _both_exit("check_voc_layout", str(tmp_path), match="test")


def test_voc_layout_size_mismatch_detected(tmp_path):
    _make_voc_tree(tmp_path)
    bad = tmp_path / "VOCtrainval_2007" / "VOCdevkit" / "VOC2007" / "JPEGImages" / "im000.jpg"
    Image.fromarray(np.zeros((50, 50, 3), np.uint8)).save(bad)
    _both_exit("check_voc_layout", str(tmp_path), match="size")


def test_coco_layout_pass(tmp_path):
    _make_coco_tree(tmp_path)
    report = port_drill.check_coco_layout(str(tmp_path))
    assert report == jax_drill.check_coco_layout(str(tmp_path))
    assert report["train2017"]["images"] == 3
    assert report["val2017"]["images"] == 3


def test_coco_layout_missing_annotations(tmp_path):
    _make_coco_tree(tmp_path)
    os.remove(tmp_path / "annotations" / "instances_val2017.json")
    _both_exit("check_coco_layout", str(tmp_path), match="instances")


def test_coco_layout_missing_image_file(tmp_path):
    _make_coco_tree(tmp_path)
    os.remove(tmp_path / "val2017" / f"{0:012d}.jpg")
    _both_exit("check_coco_layout", str(tmp_path), match="absent")


def test_checkpoint_census_roundtrip(voc_and_checkpoint):
    _, ckpt = voc_and_checkpoint
    census = port_drill.check_checkpoint(ckpt, "legacy", 21)
    assert census == jax_drill.check_checkpoint(ckpt, "legacy", 21)
    assert census["params"] > 1_000_000


def test_checkpoint_rejects_html(tmp_path):
    p = tmp_path / "fake.pth.tar"
    p.write_bytes(b"<html>not a checkpoint</html>")
    _both_exit("check_checkpoint", str(p), "legacy", 21, match="HTML")


def test_checkpoint_refuses_the_fpn_generation(tmp_path):
    """A readable file, but the FPN generation has no released checkpoint."""
    p = tmp_path / "fpn.pth.tar"
    torch.save({"model_state_dict": {"w": torch.zeros(1 << 19)}}, p)  # past the 1 MiB floor
    _both_exit("check_checkpoint", str(p), "fpn", 91, match="only the legacy generation")


def _both_mini_evals(root, ckpt, data_type, tmp_path, monkeypatch):
    """Both drills' ``run_mini_eval`` on one tree and checkpoint: (the
    JAX result, its dumped detections, the port's result)."""
    import faster_rcnn_pytorch_tpu.engine.evaluate as jax_evaluate
    import faster_rcnn_pytorch_tpu.utils.runtime as jax_runtime
    from faster_rcnn_pytorch_tpu.config import load_options as jax_options
    from faster_rcnn_pytorch_tpu_torch.config import load_options

    # keep the test session's jax compile-cache settings
    monkeypatch.setattr(jax_runtime, "setup_runtime", lambda: None)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    # the JAX drill's evaluate, dumping its detections
    dump = str(tmp_path / "jax.pkl")
    evaluate = jax_evaluate.evaluate
    monkeypatch.setattr(jax_evaluate, "evaluate", lambda *a, **k: evaluate(*a, dump_path=dump, **k))
    args = _eval_args(root, ckpt, data_type)
    want = jax_drill.run_mini_eval(jax_options(args), LIMIT)
    got = port_drill.run_mini_eval(load_options(args), LIMIT)
    with open(dump, "rb") as f:
        return want, pickle.load(f)["predictions"], got


def _assert_mini_evals_agree(want, jax_dets, got):
    assert got["images"] == want["images"] == LIMIT
    assert list(got["detections"]) == list(jax_dets) == [0, 1]
    n_det = sum(len(d["scores"]) for d in got["detections"].values())
    assert n_det == sum(len(d["scores"]) for d in jax_dets.values()) and n_det > 0
    assert abs(got["map"] - want["map"]) <= 1e-3
    for i, d in got["detections"].items():
        assert_detections_match(d, jax_dets[i], box_tol=BOX_TOL_PX)


def test_mini_eval_matches_jax(voc_and_checkpoint, tmp_path, monkeypatch):
    _assert_mini_evals_agree(*_both_mini_evals(*voc_and_checkpoint, "voc", tmp_path, monkeypatch))


def test_mini_eval_matches_jax_on_coco(coco_and_checkpoint, tmp_path, monkeypatch):
    """The COCO branch: ``CocoIndex`` on ``instances_val2017.json``, the
    legacy label map (contiguous -> category id) and COCO scoring, on an
    81-class checkpoint. The FPN generation has no checkpoint both
    packages load (its fresh inits differ), so legacy is the one compared."""
    want, jax_dets, got = _both_mini_evals(*coco_and_checkpoint, "coco", tmp_path, monkeypatch)
    _assert_mini_evals_agree(want, jax_dets, got)
    assert want["map"] > 0


def test_preflight_main_end_to_end(voc_and_checkpoint, capsys, monkeypatch):
    """The port's whole drill through its CLI surface: layout, census,
    bounded eval and the port's recipe commands."""
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(port_drill.LIMIT_ENV, str(LIMIT))
    root, ckpt = voc_and_checkpoint
    assert port_drill.main(_eval_args(root, ckpt)) == 0
    out = capsys.readouterr().out
    assert re.search(r'checkpoint ok: .*"torch_keys": \d+, "params": \d+', out), out
    assert f'mini eval ok: {{"map": ' in out and f'"images": {LIMIT}}}' in out, out
    assert "python -m faster_rcnn_pytorch_tpu_torch.test --config configs/voc_train.txt" in out


def test_preflight_main_fpn_coco_fresh_init(tmp_path, capsys, monkeypatch):
    """``--data_type coco --model_generation fpn`` with no checkpoint: the
    seeded fresh init, scored against ``instances_val2017.json``."""
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    _make_coco_tree(tmp_path)
    argv = [
        "--data_type", "coco", "--model_generation", "fpn", "--num_classes", "91",
        "--data_root", str(tmp_path), "--resize", "64", "--max_size", "96",
        "--dtype", "float32", "--num_workers", "0", "--log_dir", str(tmp_path / "logs"),
    ]
    assert port_drill.main(argv) == 0
    out = capsys.readouterr().out
    assert '"val2017": {"images": 3, "categories": 1}' in out, out
    assert "fresh init with seed 0" in out and '"images": 3}' in out, out


def test_preflight_needs_a_card_or_the_cpu_choice(voc_and_checkpoint, monkeypatch):
    monkeypatch.delenv("FRT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, ckpt = voc_and_checkpoint
    with pytest.raises(RuntimeError, match="FRT_TORCH_DEVICE=cpu"):
        port_drill.main(_eval_args(root, ckpt))

"""The port's serving export (``serving.py``, ``export.py``) on the CPU.

The tiny legacy detector of ``tests/test_torch_legacy_predict.py`` (6
classes, 64x96 canvas, JAX ``init_detector_params`` weights through
``legacy_state_dict_from_jax``) and the FPN one of
``tests/test_torch_fpn_predict.py`` (7 classes, 208x240), float32:

* an artifact, saved and loaded back, gives packed detections identical to
  direct ``predict`` (the same program on the same device);
* it agrees with the JAX package's ``make_serving_fn`` on the same weights
  at ``test_torch_legacy_predict.py``'s tolerance: detections
  greedy-matched by label and IoU >= 0.99, 99% matched, score and box
  ``|d| <= 1e-4`` (canvas units);
* a params-sidecar artifact holds no weight tensor and equals the baked one;
* ``ExportedDetector`` routes by shape (over sidecar artifacts sharing one
  weights file) and raises on an unknown bucket; the manifest merge keeps
  earlier entries;
* the export CLI under ``FRT_TORCH_DEVICE=cpu`` writes artifacts, the
  sidecar and ``manifest.json``, and raises without a card when the CPU is
  not asked for; ``--export_torch`` writes a blob that loads with
  ``strict=True`` and equals the JAX ``save_torch_checkpoint``'s.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.serving import make_serving_fn
from faster_rcnn_pytorch_tpu_torch import serving
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils.runtime import DEVICE_ENV
from tests.test_torch_legacy_predict import (  # noqa: F401  (models: the fixture)
    CANVAS_HW,
    assert_detections_match,
    models,
)
from tests.test_torch_resnet_fpn import CANVAS_HW as FPN_CANVAS_HW
from tests.test_torch_resnet_fpn import fpn_models


@pytest.fixture(scope="module")
def legacy(models):  # noqa: F811
    jmodel, jcfg, params, pmodel, pcfg = models
    rs = np.random.RandomState(4)
    images = rs.normal(size=(2, *CANVAS_HW, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.75, 0.875]], np.float32)
    return jmodel, jcfg, params, pmodel, pcfg, images, extents


@pytest.fixture
def tmp_path(tmp_path):
    """The test's ``tmp_path``, deleted when the test ends: the artifacts and
    weight files written there are hundreds of MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _packed_dets(packed, b):
    row = np.asarray(packed)[b]
    ok = row[:, 6] > 0.5
    return {"boxes": row[ok, :4], "labels": row[ok, 4].astype(np.int32), "scores": row[ok, 5]}


def _export_and_load(tmp_path, model, cfg, canvas_hw, batch, **kw):
    ep = serving.export_predict(model, cfg, canvas_hw, batch, 0.05, **kw)
    path = os.path.join(tmp_path, serving.artifact_name(canvas_hw, batch))
    serving.save_artifact(ep, path)
    return ep, path, serving.load_artifact(path)


def test_legacy_artifact_equals_direct_predict_and_jax(legacy, tmp_path):
    jmodel, jcfg, params, pmodel, pcfg, images, extents = legacy
    _, path, call = _export_and_load(tmp_path, pmodel, pcfg, CANVAS_HW, 2)
    assert os.path.getsize(path) > 0
    ti, te = torch.tensor(images), torch.tensor(extents)
    with torch.no_grad():
        got = call(ti, te)
    want = serving.pack_detections(pfr.predict(pmodel, pcfg, ti, te, 0.05))
    assert got.shape == (2, pcfg.max_detections, 7)
    assert torch.equal(got, want)
    ref = make_serving_fn(jmodel, jcfg, params, 0.05)(jnp.asarray(images), jnp.asarray(extents))
    assert np.asarray(ref).shape == tuple(got.shape)
    for b in range(2):
        w = _packed_dets(ref, b)
        assert len(w["scores"]) > 0, "no detections to compare"
        assert_detections_match(_packed_dets(got, b), w)


def test_fpn_artifact_equals_direct_predict_and_jax(tmp_path):
    jmodel, cfg, params, pmodel, _ = fpn_models()
    cfg = dataclasses.replace(cfg, pre_nms_test=256, post_nms_test=64)
    rs = np.random.RandomState(3)
    images = rs.normal(size=(2, *FPN_CANVAS_HW, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.8, 0.9]], np.float32)
    _, _, call = _export_and_load(tmp_path, pmodel, cfg, FPN_CANVAS_HW, 2)
    ti, te = torch.tensor(images), torch.tensor(extents)
    with torch.no_grad():
        got = call(ti, te)
    assert torch.equal(got, serving.pack_detections(pfr.predict(pmodel, cfg, ti, te, 0.05)))
    ref = make_serving_fn(jmodel, cfg, params, 0.05)(jnp.asarray(images), jnp.asarray(extents))
    for b in range(2):
        w = _packed_dets(ref, b)
        assert len(w["scores"]) > 0, "no detections to compare"
        assert_detections_match(_packed_dets(got, b), w)


def test_sidecar_artifact_holds_no_weight_and_equals_baked(legacy, tmp_path):
    _, _, _, pmodel, pcfg, images, extents = legacy
    baked_ep, baked_path, baked = _export_and_load(tmp_path, pmodel, pcfg, CANVAS_HW, 2)
    side_dir = os.path.join(tmp_path, "side")
    os.makedirs(side_dir)
    side_ep, side_path, side = _export_and_load(side_dir, pmodel, pcfg, CANVAS_HW, 2, params_as_args=True)
    weights = serving.serving_params(pmodel)
    assert len(baked_ep.state_dict) > 0 and len(side_ep.state_dict) == 0
    weight_shapes = {tuple(v.shape) for v in weights.values() if v.dim() > 1}
    assert not any(tuple(c.shape) in weight_shapes for c in side_ep.constants.values())
    assert os.path.getsize(side_path) * 20 < os.path.getsize(baked_path)
    sidecar = os.path.join(side_dir, serving.PARAMS_SIDECAR)
    serving.save_params_sidecar(pmodel, sidecar)
    params = serving.load_params_sidecar(sidecar, "cpu")
    assert set(params) == set(weights)
    ti, te = torch.tensor(images), torch.tensor(extents)
    with torch.no_grad():
        assert torch.equal(side(params, ti, te), baked(ti, te))
    # the model the sidecar program was traced from is untouched
    assert all(type(p) is torch.nn.Parameter and p.device.type == "cpu" for p in pmodel.parameters())


def test_exported_detector_routes_by_shape(legacy, tmp_path):
    _, _, _, pmodel, pcfg, images, extents = legacy
    entries = []
    for batch, hw in ((1, CANVAS_HW), (2, CANVAS_HW), (1, CANVAS_HW[::-1])):
        ep = serving.export_predict(pmodel, pcfg, hw, batch, 0.05, params_as_args=True)
        name = serving.artifact_name(hw, batch)
        serving.save_artifact(ep, os.path.join(tmp_path, name))
        entries.append(
            {"file": name, "canvas_hw": list(hw), "batch": batch, "platforms": ["cpu"], "params_as_args": True}
        )
    serving.save_params_sidecar(pmodel, os.path.join(tmp_path, serving.PARAMS_SIDECAR))
    serving.write_manifest(str(tmp_path), entries, extra={"params_file": serving.PARAMS_SIDECAR})
    det = serving.ExportedDetector(str(tmp_path), "cpu")
    assert det.buckets() == [(1, (64, 96)), (1, (96, 64)), (2, (64, 96))]
    ti, te = torch.tensor(images), torch.tensor(extents)
    want = serving.pack_detections(pfr.predict(pmodel, pcfg, ti, te, 0.05))
    assert torch.equal(det(ti, te), want)
    one = serving.pack_detections(pfr.predict(pmodel, pcfg, ti[:1], te[:1], 0.05))
    assert torch.equal(det(ti[:1], te[:1]), one)
    portrait = torch.zeros((1, *CANVAS_HW[::-1], 3))
    assert det(portrait, torch.ones(1, 2)).shape == (1, pcfg.max_detections, 7)
    with pytest.raises(ValueError, match="no artifact for batch=3"):
        det(torch.zeros((3, *CANVAS_HW, 3)), torch.ones(3, 2))
    assert serving.ExportedDetector(str(tmp_path), "cuda").buckets() == []


def test_manifest_merge_keeps_prior_entries(tmp_path):
    serving.write_manifest(str(tmp_path), [{"file": "a.pt2", "canvas_hw": [64, 64], "batch": 1}])
    serving.write_manifest(str(tmp_path), [{"file": "b.pt2", "canvas_hw": [64, 64], "batch": 8}])
    serving.write_manifest(str(tmp_path), [{"file": "a.pt2", "canvas_hw": [64, 64], "batch": 1}])
    with open(os.path.join(tmp_path, "manifest.json")) as f:
        manifest = json.load(f)
    assert sorted(e["file"] for e in manifest["artifacts"]) == ["a.pt2", "b.pt2"]
    assert manifest["format"] == "torch.export"
    # the calling convention a client of either server reads, word for word
    from faster_rcnn_pytorch_tpu.serving import write_manifest as jax_write_manifest

    jax_dir = os.path.join(tmp_path, "jax")
    os.makedirs(jax_dir)
    with open(jax_write_manifest(jax_dir, [])) as f:
        assert manifest["call"] == json.load(f)["call"]


def _cli_args(tmp_path, *extra):
    return [
        "--data_type", "voc", "--resize", "64", "--max_size", "96", "--batch_size", "1",
        "--dtype", "float32", "--log_dir", os.path.join(tmp_path, "logs"), *extra,
    ]


def test_export_cli_writes_artifacts_sidecar_and_manifest(tmp_path, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.export import main

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    out = os.path.join(tmp_path, "export")
    argv = _cli_args(tmp_path, "--export_dir", out, "--params_sidecar", "true", "--export_platforms", "cpu")
    assert main(argv) == 0
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["num_classes"] == 21 and manifest["params_file"] == serving.PARAMS_SIDECAR
    assert [e["canvas_hw"] for e in manifest["artifacts"]] == [[64, 96], [96, 64]]
    det = serving.ExportedDetector(out, "cpu")
    for batch, (h, w) in det.buckets():
        packed = det(torch.zeros((batch, h, w, 3)), torch.ones((batch, 2)))
        assert packed.shape == (batch, 100, 7)
        assert all(e["params_as_args"] and e["platforms"] == ["cpu"] for e in manifest["artifacts"])


def test_export_clis_raise_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs run on it")
    from faster_rcnn_pytorch_tpu_torch import demo, export, serve

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        export.main(_cli_args(tmp_path, "--export_dir", os.path.join(tmp_path, "x")))
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        demo.main(_cli_args(tmp_path, "--demo_root", str(tmp_path)))
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        serve.main(["--export_dir", str(tmp_path), "--port", "0"])
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    with pytest.raises(ValueError, match="needs the card"):
        export.main(_cli_args(tmp_path, "--export_platforms", "cpu,cuda"))


def test_export_torch_blob_loads_strict_and_equals_jax(tmp_path, monkeypatch):
    from faster_rcnn_pytorch_tpu.utils.checkpoint import save_torch_checkpoint
    from faster_rcnn_pytorch_tpu_torch.export import main

    jmodel, _ = jfr.build_model("legacy", num_classes=21, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(1), canvas=64))
    jax_blob = os.path.join(tmp_path, "jax.pth.tar")
    save_torch_checkpoint(jax_blob, params, "legacy")

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    port_blob = os.path.join(tmp_path, "port.pth.tar")
    assert main(_cli_args(tmp_path, "--checkpoint", jax_blob, "--export_torch", port_blob)) == 0
    got = torch.load(port_blob, weights_only=True)
    want = torch.load(jax_blob, weights_only=True)
    assert got["epoch"] == want["epoch"] == 0
    assert set(got["model_state_dict"]) == set(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    model, _ = pfr.build_model("legacy", 21)
    model.load_state_dict(got["model_state_dict"], strict=True)

"""The port's legacy detector against the JAX package on the same weights.

JAX params come from ``init_detector_params`` (6 classes, 64-px canvas);
the port loads them through ``legacy_state_dict_from_jax``. Float32
throughout (TF32 is off on the port side). Tolerances:

* state dict: identical to ``export_legacy_torch_state_dict``;
* VGG features and RPN outputs: ``max|d| <= 1e-4 * max|ref|`` (two conv
  stacks summing in different orders);
* ``propose`` fed the JAX RPN outputs: identical valid masks and order,
  rois within atol 1e-6;
* whole ``predict``: detections greedy-matched by label and IoU >= 0.99,
  at least 99% matched, score and box ``|d| <= 1e-4`` (canvas units).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.models.rpn import propose as jax_propose
from faster_rcnn_pytorch_tpu.utils.checkpoint import export_legacy_torch_state_dict
from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models.rpn import propose as port_propose
from faster_rcnn_pytorch_tpu_torch.utils.convert import legacy_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics

CANVAS_HW = (64, 96)
NUM_CLASSES = 6


def assert_detections_match(a, b, score_tol=1e-4, box_tol=1e-4):
    ok, summary = detections_agree(a, b, score_tol=score_tol, box_tol=box_tol)
    assert ok, summary


@pytest.fixture(scope="module")
def models():
    set_numerics("float32")
    jmodel, jcfg = jfr.build_model("legacy", num_classes=NUM_CLASSES, dtype=jnp.float32)
    params = jfr.init_detector_params(jmodel, jax.random.key(0), canvas=64)
    params = jax.tree.map(np.asarray, params)
    pmodel, pcfg = pfr.build_model("legacy", num_classes=NUM_CLASSES)
    pmodel.load_state_dict(legacy_state_dict_from_jax(params), strict=True)
    pmodel.eval()
    return jmodel, jcfg, params, pmodel, pcfg


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    images = rs.normal(size=(2, *CANVAS_HW, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.75, 0.875]], np.float32)
    images[1, 56:] = 0.0  # padded canvas rows / cols beyond the extent
    images[1, :, 72:] = 0.0
    return images, extents


def test_state_dict_from_jax_equals_export(models):
    _, _, params, pmodel, _ = models
    want = export_legacy_torch_state_dict(params)
    got = legacy_state_dict_from_jax(params)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(pmodel.state_dict()) == set(want)
    assert pmodel.classifier is pmodel.fast_rcnn_head.classifier


def _rel_close(got, want, rel=1e-4):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_features_and_rpn_outputs_match_jax(models, inputs):
    jmodel, _, params, pmodel, _ = models
    images, _ = inputs
    j_feats = jmodel.apply(params, jnp.asarray(images), method="features")
    j_cls, j_reg = jmodel.apply(params, j_feats, method="rpn_out")
    with torch.no_grad():
        p_feats = pmodel.features(torch.tensor(images).permute(0, 3, 1, 2).contiguous())
        p_cls, p_reg = pmodel.rpn_out(p_feats)
    _rel_close(p_feats.permute(0, 2, 3, 1).numpy(), np.asarray(j_feats))
    assert p_cls.dtype == torch.float32 and p_cls.shape == j_cls.shape
    _rel_close(p_cls.numpy(), np.asarray(j_cls))
    _rel_close(p_reg.numpy(), np.asarray(j_reg))


def test_propose_on_jax_rpn_outputs_matches(models, inputs):
    jmodel, cfg, params, pmodel, _ = models
    images, extents = inputs
    j_feats = jmodel.apply(params, jnp.asarray(images), method="features")
    j_cls, j_reg = jmodel.apply(params, j_feats, method="rpn_out")
    anchors = pmodel.canvas_anchors(*CANVAS_HW)
    for i in range(images.shape[0]):
        kw = dict(
            pre_k=cfg.pre_nms_test, post_k=cfg.post_nms_test, nms_iou=cfg.rpn_nms_iou,
            min_size=cfg.proposal_min_size, nms_tile=cfg.rpn_nms_tile,
        )
        want = jax_propose(j_cls[i], j_reg[i], jnp.asarray(anchors), jnp.asarray(extents[i]), **kw)
        got = port_propose(
            torch.tensor(np.asarray(j_cls[i])), torch.tensor(np.asarray(j_reg[i])),
            torch.tensor(anchors), torch.tensor(extents[i]), **kw,
        )
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert got.valid.sum() > 0
        np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)


def _valid_dets(det, b):
    ok = np.asarray(det.valid[b]).astype(bool)
    return {
        "boxes": np.asarray(det.boxes[b])[ok],
        "labels": np.asarray(det.labels[b])[ok],
        "scores": np.asarray(det.scores[b])[ok],
    }


def test_predict_matches_jax(models, inputs):
    import dataclasses

    jmodel, cfg, params, pmodel, _ = models
    images, extents = inputs
    cfg = dataclasses.replace(cfg, max_detections=cfg.post_nms_test * (NUM_CLASSES - 1))
    want = jmodel.apply(
        params, cfg, jnp.asarray(images), jnp.asarray(extents), 0.05, method=jfr.predict
    )
    got = pfr.predict(pmodel, cfg, torch.tensor(images), torch.tensor(extents), 0.05)
    assert got.boxes.shape == tuple(want.boxes.shape)
    assert got.labels.dtype == torch.int32
    for b in range(images.shape[0]):
        assert_detections_match(_valid_dets(got, b), _valid_dets(want, b))

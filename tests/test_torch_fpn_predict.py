"""Whole FPN predict, the port against the JAX package on the CPU.

Same weights (``fpn_models`` of test_torch_resnet_fpn: JAX init with
seeded FrozenBN statistics, 7 classes), float32, batch 2 with extents
(1, 1) and (0.8, 0.9) on the 208x240 canvas, small budgets (2000 -> 256
pre-NMS, 64 proposals) and a 0.05 threshold, COCO's 100 detections per
image. Detections are greedy-matched as in test_torch_legacy_predict
(label, IoU >= 0.99, 99% matched, score and box ``|d| <= 1e-4``), and
there must be some.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.ops import roi_align
from tests.test_torch_legacy_predict import _valid_dets, assert_detections_match
from tests.test_torch_resnet_fpn import CANVAS_HW, fpn_models


@pytest.fixture(scope="module")
def setup():
    jmodel, cfg, params, pmodel, _ = fpn_models()
    cfg = dataclasses.replace(cfg, pre_nms_test=256, post_nms_test=64)
    rs = np.random.RandomState(3)
    images = rs.normal(size=(2, *CANVAS_HW, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.8, 0.9]], np.float32)
    h, w = CANVAS_HW
    images[1, int(0.9 * h) :] = 0.0  # padded canvas beyond the extent
    images[1, :, int(0.8 * w) :] = 0.0
    return jmodel, cfg, params, pmodel, images, extents


def test_fpn_predict_matches_jax(setup):
    jmodel, cfg, params, pmodel, images, extents = setup
    want = jmodel.apply(
        params, cfg, jnp.asarray(images), jnp.asarray(extents), 0.05, method=jfr.predict
    )
    before = roi_align.multiscale_roi_align_cuda.launches
    got = pfr.predict(pmodel, cfg, torch.tensor(images), torch.tensor(extents), 0.05)
    assert roi_align.multiscale_roi_align_cuda.launches == before  # CPU: the plain version
    assert got.boxes.shape == tuple(want.boxes.shape) == (2, cfg.max_detections, 4)
    for b in range(images.shape[0]):
        g, w = _valid_dets(got, b), _valid_dets(want, b)
        assert len(w["scores"]) > 0, "no detections to compare"
        assert_detections_match(g, w)


def test_predict_stage_hook_sees_every_stage(setup):
    """``on_stage`` (the stage timer's hook) sees every stage in order and
    leaves the detections as they are without it."""
    _, cfg, _, pmodel, images, extents = setup
    args = (pmodel, cfg, torch.tensor(images), torch.tensor(extents), 0.05)
    seen = []
    got = pfr.predict(*args, on_stage=lambda name, result: seen.append((name, result)))
    want = pfr.predict(*args)
    assert [name for name, _ in seen] == list(pfr.PREDICT_STAGES)
    assert seen[-1][1] is got
    probs = dict(seen)["decode"]
    assert probs.shape == (2, cfg.post_nms_test, cfg.num_classes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

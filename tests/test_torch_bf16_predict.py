"""The port's bfloat16 predict against the JAX package's bfloat16 predict.

The same float32 weights go to both packages, and each casts them for
bfloat16 inference its own way: the JAX package with
``utils/params.py::cast_inference_params`` under a ``dtype=bfloat16``
model, the port with ``utils/runtime.py::inference_weights`` (FrozenBN
statistics stay float32 in both). The inputs are those of the float32
tests: legacy as ``tests/test_torch_legacy_predict.py`` (6 classes, a
64x96 canvas, batch 2, every candidate kept), FPN as
``tests/test_torch_fpn_predict.py`` (7 classes, 208x240, batch 2, 2000 ->
256 -> 64 proposals).

Detections are compared with ``evaluation/diff.py::detections_agree``:
greedy pairs by label at IoU >= 0.99, at least 99% of the larger set
paired, and score and box differences within twice what bfloat16 rounding
moves the JAX package's own detections on these inputs: the largest score
and box ``|d|`` between its bfloat16 predict and the float32 predict
(the port's float32 predict stands for it: it is the JAX package's within
1e-4, ``tests/test_torch_legacy_predict.py``). The weights are the port's
seeded fresh init, whose activations are O(1) through the stack: there
bfloat16 moves scores and boxes by about 1e-3, so a fixed bound would
mean nothing without the inputs. Twice the rounding's own size passes
two roundings that go different ways and fails a cast or a fold done
otherwise than the JAX package does it.

The FPN case does not agree, and is kept as ``xfail(strict=True)`` (ROADMAP
Queue C): 96 and 91 of 100 detections pair up, where 99 must; the pairs
are within 0.00105 (score) and 0.00011 (box), inside the tolerances. The
JAX package's bfloat16 predict pairs 96 and 92 of 100 with its own
float32 predict on these inputs: with random weights the RPN's
objectness is nearly tied across the 12501 anchors, so a bfloat16
rounding changes which anchors make the cuts of 256 and 64, in either
package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.utils import checkpoint as jck
from faster_rcnn_pytorch_tpu.utils.params import cast_inference_params
from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree, greedy_match
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models.resnet import FrozenBatchNorm2d
from faster_rcnn_pytorch_tpu_torch.utils.runtime import inference_weights, set_numerics
from tests.test_torch_legacy_predict import _valid_dets


def _differences(a: dict, b: dict) -> tuple[float, float]:
    """Largest score and box ``|d|`` over the greedy pairs of ``a`` and ``b``."""
    pairs = greedy_match(a, b)
    assert pairs, "nothing paired"
    i, j = (np.array(x) for x in zip(*pairs))
    return (
        float(np.abs(a["scores"][i] - b["scores"][j]).max()),
        float(np.abs(a["boxes"][i] - b["boxes"][j]).max()),
    )


def _seeded(generation: str, num_classes: int, seed: int):
    """The port's seeded fresh init (FPN: with seeded FrozenBN statistics,
    scale in [0.3, 0.9], so the BN path is not the identity) and the same
    weights as JAX params, through the JAX package's importer."""
    set_numerics("float32")
    pmodel, cfg = pfr.build_model(generation, num_classes)
    pfr.init_weights(pmodel, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    for m in pmodel.modules():
        if isinstance(m, FrozenBatchNorm2d):
            n = m.weight.shape
            for name, lo, hi in (("weight", 0.3, 0.9), ("bias", -0.2, 0.2),
                                 ("running_mean", -0.2, 0.2), ("running_var", 0.5, 2.0)):
                getattr(m, name).copy_(torch.from_numpy(rs.uniform(lo, hi, n).astype(np.float32)))
    importer = jck.import_legacy_torch_params if generation == "legacy" else jck.import_fpn_torch_params
    params = importer({k: v.numpy() for k, v in pmodel.state_dict().items()}, num_classes)
    return params, pmodel.eval(), cfg


def _legacy():
    params, pmodel, cfg = _seeded("legacy", 6, 0)
    # 64 proposal slots hold every survivor of the 216 anchors' NMS; every
    # detection is kept
    cfg = dataclasses.replace(cfg, post_nms_test=64, max_detections=64 * 5)
    rs = np.random.RandomState(0)
    images = rs.normal(size=(2, 64, 96, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.75, 0.875]], np.float32)
    images[1, 56:] = 0.0
    images[1, :, 72:] = 0.0
    return params, pmodel, cfg, images, extents


def _fpn():
    params, pmodel, cfg = _seeded("fpn", 7, 0)
    cfg = dataclasses.replace(cfg, pre_nms_test=256, post_nms_test=64)
    rs = np.random.RandomState(3)
    images = rs.normal(size=(2, 208, 240, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.8, 0.9]], np.float32)
    images[1, int(0.9 * 208) :] = 0.0
    images[1, :, int(0.8 * 240) :] = 0.0
    return params, pmodel, cfg, images, extents


CASES = [
    pytest.param("legacy", _legacy, id="legacy"),
    pytest.param(
        "fpn",
        _fpn,
        id="fpn",
        marks=pytest.mark.xfail(
            strict=True,
            reason="ROADMAP Queue C: 96 and 91 of 100 FPN detections pair up (99 needed); "
            "the JAX bfloat16 predict pairs 96 and 92 with its own float32 one",
        ),
    ),
]


@pytest.mark.parametrize("generation,setup", CASES)
def test_bfloat16_predict_agrees_with_jax(generation, setup):
    params, pmodel, cfg, images, extents = setup()
    jmodel, _ = jfr.build_model(generation, num_classes=cfg.num_classes, dtype=jnp.bfloat16)
    # jitted, as the JAX package's evaluate runs it (engine/evaluate.py)
    jax_predict = jax.jit(lambda p, im, ex: jmodel.apply(p, cfg, im, ex, 0.05, method=jfr.predict))
    want = jax_predict(cast_inference_params(params, jnp.bfloat16), jnp.asarray(images), jnp.asarray(extents))
    args = (pmodel, cfg, torch.tensor(images), torch.tensor(extents), 0.05)
    with inference_weights(pmodel, torch.bfloat16), torch.no_grad():
        assert next(pmodel.parameters()).dtype == torch.bfloat16
        got = pfr.predict(*args)
    assert next(pmodel.parameters()).dtype == torch.float32  # the float32 weights are back
    with torch.no_grad():
        f32 = pfr.predict(*args)
    for b in range(images.shape[0]):
        g, w = _valid_dets(got, b), _valid_dets(want, b)
        assert len(w["scores"]) > 0, "no detections to compare"
        score_tol, box_tol = (2 * d for d in _differences(w, _valid_dets(f32, b)))
        ok, summary = detections_agree(g, w, score_tol=score_tol, box_tol=box_tol)
        assert ok, f"image {b}: {summary} (tolerances {score_tol:.3g}, {box_tol:.3g})"

"""Port NMS against the JAX package's fixed-shape NMS and a numpy greedy
oracle.

Same inputs into both give identical keep indices, valid flags and
labels; kept boxes and scores agree to atol 1e-6 (they are gathered
copies of the inputs, so in practice exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib

from faster_rcnn_pytorch_tpu_torch.ops import nms as pnms
from tests.conftest import boxes_fixture
from tests.test_nms import np_greedy_nms

# ops/__init__ re-exports the function `nms`, which shadows the module
jnms = importlib.import_module("faster_rcnn_pytorch_tpu.ops.nms")

ATOL = 1e-6


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _scores(rs, n, ties):
    s = rs.uniform(size=n).astype(np.float32)
    if ties:  # few distinct values: ordering rests on the stable sort
        s = np.round(s * 8) / 8
    return s.astype(np.float32)


@pytest.mark.parametrize(
    "n,thr,tile,post_k,ties,masked",
    [
        (300, 0.5, 64, 300, False, False),
        (300, 0.3, 64, 40, False, True),
        (257, 0.7, 256, 257, True, False),
        (500, 0.5, 128, 500, True, True),
        (12, 0.5, 256, 20, False, True),
    ],
)
def test_nms_matches_jax_and_greedy_oracle(n, thr, tile, post_k, ties, masked):
    rs = np.random.RandomState(n + int(thr * 10))
    boxes = boxes_fixture(rs, n)
    scores = _scores(rs, n, ties)
    valid = rs.uniform(size=n) > 0.3 if masked else None

    j_idx, j_ok = jnms.nms(
        _j(boxes), _j(scores), thr, post_k=post_k,
        valid=None if valid is None else _j(valid), tile=tile,
    )
    p_idx, p_ok = pnms.nms(
        _t(boxes), _t(scores), thr, post_k=post_k,
        valid=None if valid is None else _t(valid), tile=tile,
    )
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_ok.numpy(), np.asarray(j_ok))
    assert p_idx.dtype == torch.int32 and p_idx.shape == (post_k,)

    sel = np.ones(n, bool) if valid is None else valid
    oracle = np.where(sel)[0][np_greedy_nms(boxes[sel], scores[sel], thr)][:post_k]
    got = p_idx.numpy()[p_ok.numpy()]
    np.testing.assert_array_equal(got, oracle)
    assert (p_idx.numpy()[~p_ok.numpy()] == -1).all()


@pytest.mark.parametrize("ties", [False, True])
def test_nms_sorted_with_boxes_and_inf_padding(ties):
    """The proposal regime: pre-sorted scores whose tail is -inf padding,
    kept boxes and scores returned."""
    rs = np.random.RandomState(7)
    n = 400
    boxes = boxes_fixture(rs, n)
    scores = np.sort(_scores(rs, n, ties))[::-1].copy()
    scores[300:] = -np.inf
    valid = scores > -np.inf
    kw = dict(post_k=120, tile=128, assume_sorted=True, return_boxes=True)
    j = jnms.nms(_j(boxes), _j(scores), 0.7, valid=_j(valid), **kw)
    p = pnms.nms(_t(boxes), _t(scores), 0.7, valid=_t(valid), **kw)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(p[2].numpy(), np.asarray(j[2]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p[3].numpy(), np.asarray(j[3]), rtol=0, atol=ATOL)


def test_batched_nms_matches_jax():
    rs = np.random.RandomState(3)
    n = 350
    boxes = boxes_fixture(rs, n, scale=37.0)
    scores = _scores(rs, n, ties=True)
    cls = rs.randint(0, 5, size=n).astype(np.int32)
    valid = rs.uniform(size=n) > 0.2
    j = jnms.batched_nms(_j(boxes), _j(scores), _j(cls), 0.4, post_k=n, valid=_j(valid), tile=64)
    p = pnms.batched_nms(_t(boxes), _t(scores), _t(cls), 0.4, post_k=n, valid=_t(valid), tile=64)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    # per-class greedy oracle
    kept = set(p[0].numpy()[p[1].numpy()].tolist())
    want = set()
    for c in range(5):
        sel = np.where((cls == c) & valid)[0]
        want |= set(sel[np_greedy_nms(boxes[sel], scores[sel], 0.4)].tolist())
    assert kept == want


def _head_outputs(rs, n, num_classes, ties, peaked):
    rois = boxes_fixture(rs, n)
    jitter = rs.normal(scale=0.02, size=(n, num_classes, 4)).astype(np.float32)
    cls_boxes = np.clip(np.concatenate([rois, rois], 1)[:, None, :4] + jitter, 0, 1)
    cls_boxes = np.concatenate(
        [np.minimum(cls_boxes[..., :2], cls_boxes[..., 2:]),
         np.maximum(cls_boxes[..., :2], cls_boxes[..., 2:])], -1
    ).astype(np.float32)
    logits = rs.normal(scale=3.0 if peaked else 1.0, size=(n, num_classes))
    if ties:
        logits = np.round(logits)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return cls_boxes, probs.astype(np.float32)


@pytest.mark.parametrize(
    "regime,n,num_classes,thres,candidate_k,ties",
    [
        ("flat", 300, 21, 0.05, None, False),
        ("flat", 120, 6, 0.01, None, True),
        ("compact", 200, 91, 0.2, None, False),
        ("compact", 200, 91, 0.2, None, True),
        ("fallback", 200, 91, 0.01, 64, False),
    ],
)
def test_multiclass_nms_regimes_match_jax(regime, n, num_classes, thres, candidate_k, ties):
    rs = np.random.RandomState(num_classes + n)
    cls_boxes, probs = _head_outputs(rs, n, num_classes, ties, peaked=regime != "fallback")
    n_valid = int((probs[:, 1:] > thres).sum())
    if regime == "flat":
        assert (num_classes - 1) * n <= 16384
    else:
        assert (num_classes - 1) * n > 16384
        k = candidate_k or max(512, 200)
        assert (n_valid <= k) == (regime == "compact"), n_valid
    kw = dict(num_classes=num_classes, per_class_k=100, max_det=100, tile=128, candidate_k=candidate_k)
    j = jnms.multiclass_nms(_j(cls_boxes), _j(probs), thres, 0.3, **kw)
    p = pnms.multiclass_nms(_t(cls_boxes), _t(probs), thres, 0.3, **kw)
    j_boxes, j_labels, j_scores, j_valid = (np.asarray(x) for x in j)
    np.testing.assert_array_equal(p[3].numpy(), j_valid)
    np.testing.assert_array_equal(p[1].numpy(), j_labels)
    np.testing.assert_allclose(p[0].numpy(), j_boxes, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p[2].numpy(), j_scores, rtol=0, atol=ATOL)
    assert j_valid.sum() > 0

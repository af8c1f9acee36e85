"""Port box ops and legacy anchors against the JAX package.

Box ops agree to atol 1e-6 (the same float32 formulas; exp/log may differ
by an ulp between XLA and PyTorch); anchors are numpy on both sides and
must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import anchors as jax_anchors
from faster_rcnn_pytorch_tpu.ops import boxes as jb
from faster_rcnn_pytorch_tpu_torch.models import anchors as port_anchors
from faster_rcnn_pytorch_tpu_torch.ops import boxes as pb
from tests.conftest import boxes_fixture

ATOL = 1e-6


def _both(x):
    return jnp.asarray(x), torch.tensor(np.asarray(x))


def _close(jax_out, port_out, atol=ATOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), rtol=0, atol=atol)


@pytest.fixture
def box_sets():
    rs = np.random.RandomState(0)
    a = boxes_fixture(rs, 37)
    b = boxes_fixture(rs, 23)
    # coincident degenerate boxes exercise the union floor / eps
    a[:3] = [0.5, 0.5, 0.5, 0.5]
    b[:2] = [0.5, 0.5, 0.5, 0.5]
    return a, b


@pytest.mark.parametrize("fn", ["cxcy_to_xy", "xy_to_cxcy", "box_area", "clip_boxes"])
def test_unary_box_ops_match_jax(box_sets, fn):
    a, _ = box_sets
    x = a * 1.4 - 0.2  # some coordinates outside [0, 1] for the clip
    ja, ta = _both(x)
    _close(getattr(jb, fn)(ja), getattr(pb, fn)(ta))


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_encode_decode_match_jax(box_sets, eps):
    a, b = box_sets
    g = jb.xy_to_cxcy(jnp.asarray(b[:20]))
    anc = jb.xy_to_cxcy(jnp.asarray(a[3:23]))
    tg, tanc = torch.tensor(np.asarray(g)), torch.tensor(np.asarray(anc))
    _close(jb.encode(g, anc, eps=eps), pb.encode(tg, tanc, eps=eps))
    deltas = np.random.RandomState(1).normal(scale=0.5, size=(20, 4)).astype(np.float32)
    jd, td = _both(deltas)
    _close(jb.decode(jd, anc), pb.decode(td, tanc))


def test_pairwise_iou_match_jax(box_sets):
    a, b = box_sets
    (ja, ta), (jbx, tbx) = _both(a), _both(b)
    _close(jb.jaccard_iou(ja, jbx), pb.jaccard_iou(ta, tbx))
    j_iou, j_union = jb.box_iou(ja, jbx)
    p_iou, p_union = pb.box_iou(ta, tbx)
    _close(j_iou, p_iou)
    _close(j_union, p_union)
    # batched leading dims broadcast the same way
    j3, _ = jb.box_iou(ja.reshape(1, 37, 4), jbx.reshape(1, 23, 4))
    p3, _ = pb.box_iou(ta.reshape(1, 37, 4), tbx.reshape(1, 23, 4))
    _close(j3, p3)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (800, 1344)])
def test_legacy_anchors_identical(hw):
    np.testing.assert_array_equal(
        port_anchors.legacy_anchors(*hw), jax_anchors.legacy_anchors(*hw)
    )
    np.testing.assert_array_equal(
        port_anchors.legacy_anchor_base(), jax_anchors.legacy_anchor_base()
    )

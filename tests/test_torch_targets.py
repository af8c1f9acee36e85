"""The port's train-target pieces against the JAX package on the same inputs.

Inputs come from numpy seeds; the sampling noise is JAX's own, recreated
with ``jax.random.split``/``uniform`` exactly as ``ops/sampling.py`` and
``models/targets.py`` draw it from a key, and handed to the port. Float32
throughout. Tolerances:

* ``masked_iou`` / ``masked_iou_gt_major``: atol 1e-7;
* ranks, sampled indices, masks and labels: identical;
* regression targets: atol 1e-6 (``log`` of two libraries);
* losses: relative 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import losses as jl
from faster_rcnn_pytorch_tpu.models import targets as jt
from faster_rcnn_pytorch_tpu.ops import boxes as jb
from faster_rcnn_pytorch_tpu.ops import sampling as js
from faster_rcnn_pytorch_tpu_torch.models import losses as pl
from faster_rcnn_pytorch_tpu_torch.models import targets as pt
from faster_rcnn_pytorch_tpu_torch.models.anchors import legacy_anchors
from faster_rcnn_pytorch_tpu_torch.ops import boxes as pb
from faster_rcnn_pytorch_tpu_torch.ops import sampling as ps
from tests.conftest import boxes_fixture

CANVAS_HW = (192, 256)


def split_noise(key, n):
    """The pos/neg noise a JAX function draws from ``key`` for ``n``
    candidates: ``k_pos, k_neg = split(key)``, then ``uniform`` of each."""
    k_pos, k_neg = jax.random.split(key)
    return (
        torch.tensor(np.asarray(jax.random.uniform(k_pos, (n,)))),
        torch.tensor(np.asarray(jax.random.uniform(k_neg, (n,)))),
    )


def padded_gt(rs, g, real, extent=(1.0, 1.0)):
    boxes = np.zeros((g, 4), np.float32)
    boxes[:real] = boxes_fixture(rs, real) * np.array(extent * 2, np.float32)
    labels = np.zeros(g, np.int32)
    labels[:real] = rs.randint(0, 5, size=real)
    mask = np.zeros(g, bool)
    mask[:real] = True
    return boxes, labels, mask


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_masked_iou_matches_jax(lead):
    rs = np.random.RandomState(0)
    boxes = boxes_fixture(rs, 37 * int(np.prod(lead))).reshape(*lead, 37, 4)
    gt = boxes_fixture(rs, 7 * int(np.prod(lead))).reshape(*lead, 7, 4)
    mask = rs.rand(*lead, 7) > 0.3
    want = np.asarray(jb.masked_iou(jnp.asarray(boxes), jnp.asarray(gt), jnp.asarray(mask)))
    got = pb.masked_iou(_t(boxes), _t(gt), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert np.where(mask[..., None, :], True, got == -1).all()


def test_masked_iou_gt_major_matches_jax():
    rs = np.random.RandomState(1)
    anchors = legacy_anchors(*CANVAS_HW)
    gt, _, mask = padded_gt(rs, 6, 4)
    want = np.asarray(jb.masked_iou_gt_major(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(anchors)))
    got = pb.masked_iou_gt_major(_t(gt), _t(mask), _t(anchors)).numpy()
    assert got.shape == (6, anchors.shape[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,k", [(500, 40), (64, 100)])
def test_group_ranks_match_jax(n, k):
    rs = np.random.RandomState(n)
    noise = np.array(jax.random.uniform(jax.random.key(n), (n,)))
    noise[::7] = noise[1]  # ties go to the lowest index in both
    mask = rs.rand(n) > 0.4
    want = np.asarray(js._group_rank(jnp.asarray(noise), jnp.asarray(mask)))
    got = ps._group_rank(_t(noise), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    want_k = np.asarray(js._group_rank_topk(jnp.asarray(noise), jnp.asarray(mask), k))
    got_k = ps._group_rank_topk(_t(noise), _t(mask), k)
    np.testing.assert_array_equal(got_k.numpy(), want_k)


@pytest.mark.parametrize("n_pos,n_neg", [(50, 300), (5, 300), (3, 20)])
def test_sample_pos_neg_matches_jax(n_pos, n_neg):
    n = 400
    rs = np.random.RandomState(n_pos + n_neg)
    perm = rs.permutation(n)
    pos = np.zeros(n, bool)
    pos[perm[:n_pos]] = True
    neg = np.zeros(n, bool)
    neg[perm[n_pos : n_pos + n_neg]] = True
    key = jax.random.key(n_pos)
    want = js.sample_pos_neg(key, jnp.asarray(pos), jnp.asarray(neg), 128, 32)
    got = ps.sample_pos_neg(*split_noise(key, n), _t(pos), _t(neg), 128, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() == min(n_pos, 32)


@pytest.mark.parametrize(
    "boundary_filter,allow_ties,quotas",
    [(True, False, (128, 256)), (True, False, (3, 12)), (False, False, (128, 256)), (False, True, (4, 16))],
)
def test_rpn_targets_match_jax(boundary_filter, allow_ties, quotas):
    rs = np.random.RandomState(3)
    anchors = legacy_anchors(*CANVAS_HW)
    extent = np.array([1.0, 0.8], np.float32)
    gt, _, mask = padded_gt(rs, 8, 3, extent=(1.0, 0.8))
    gt[1] = [0.1, 0.05, 0.7, 0.75]  # large: many anchors above 0.7 IoU
    if not boundary_filter:
        gt[2] = anchors[0]  # its best anchor is index 0, as is every padded slot's
    key = jax.random.key(11)
    kw = dict(
        pos_quota=quotas[0], total_quota=quotas[1],
        allow_ties=allow_ties, boundary_filter=boundary_filter,
    )
    want = jt.rpn_targets(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(extent), key, **kw
    )
    got = pt.rpn_targets(
        _t(anchors), _t(gt), _t(mask), _t(extent), *split_noise(key, anchors.shape[0]), **kw
    )
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels == 1).sum() > 0 and (got.labels == 0).sum() > 0
    if not boundary_filter and quotas[0] >= 128:  # no positive demoted
        assert got.labels[0] == 1
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "samples,quota,n_rois,slots,real",
    [
        pytest.param(128, 32, 300, 10, 4, id="128-32"),
        pytest.param(64, 8, 300, 10, 4, id="64-8"),
        # a dense scene (--max_gt 512): (2000 + 512) x 512 candidate pairs,
        # past masked_iou's kernel gate, where the port's CPU path takes the
        # kernel's plain twin and the JAX package's its jaccard_iou
        pytest.param(128, 32, 2000, 512, 400, id="dense-2000-512"),
    ],
)
def test_frcnn_targets_match_jax(samples, quota, n_rois, slots, real):
    rs = np.random.RandomState(5)
    gt, labels, mask = padded_gt(rs, slots, real)
    rois = boxes_fixture(rs, n_rois)
    # proposals around the gt boxes, so there are positives to sample
    near = min(10 * real, n_rois // 2)
    rois[:near] = np.clip(np.repeat(gt[:real], 10, 0)[:near] + rs.normal(0, 0.02, (near, 4)), 0, 1)
    valid = rs.rand(n_rois) > 0.1
    assert ((n_rois + slots) * slots >= pb.IOU_KERNEL_MIN_PAIRS) == (slots == 512)
    key = jax.random.key(7)
    kw = dict(num_samples=samples, pos_quota=quota, label_offset=1)
    want = jt.frcnn_targets(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(mask), key, **kw,
    )
    got = pt.frcnn_targets(
        _t(rois), _t(valid), _t(gt), _t(labels), _t(mask), *split_noise(key, n_rois + slots), **kw
    )
    for name in ("rois", "labels", "is_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.is_pos.sum() == quota
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets), rtol=0, atol=1e-6)


def _loss_inputs(rs, b=2, a=300, s=64, c=6, ignore_all=False):
    rpn_lab = rs.randint(-1, 2, size=(b, a)).astype(np.int32)
    roi_lab = rs.randint(-1, c, size=(b, s)).astype(np.int32)
    if ignore_all:
        rpn_lab[:] = -1
        roi_lab[:] = -1
    pred = (
        rs.normal(size=(b, a, 2)), rs.normal(size=(b, a, 4)) * 0.3,
        rs.normal(size=(b, s, c)), rs.normal(size=(b, s, 4)),
    )
    target = (rpn_lab, rs.normal(size=(b, a, 4)) * 0.3, roi_lab, rs.normal(size=(b, s, 4)))
    f32 = lambda xs: [x.astype(np.float32) if x.dtype == np.float64 else x for x in xs]  # noqa: E731
    return f32(pred), f32(target)


@pytest.mark.parametrize("ignore_all", [False, True])
def test_losses_match_jax(ignore_all):
    pred, target = _loss_inputs(np.random.RandomState(9), ignore_all=ignore_all)
    want = jl.frcnn_loss([jnp.asarray(x) for x in pred], [jnp.asarray(x) for x in target])
    (rpn_cls, rpn_reg, roi_cls, roi_reg), (tg_rpn, tg_rpn_reg, tg_roi, tg_roi_reg) = (
        [_t(x) for x in xs] for xs in (pred, target)
    )
    got = pl.frcnn_loss(
        (rpn_cls, rpn_reg), (tg_rpn, tg_rpn_reg), [pl.stage_sums(roi_cls, roi_reg, tg_roi, tg_roi_reg)]
    )
    for name, g, w in zip(pl.LossBreakdown._fields, got, want):
        w = float(w)
        assert abs(float(g) - w) <= 1e-6 * max(abs(w), 1e-30), (name, float(g), w)
    if ignore_all:
        assert float(got.total) == 0.0
    else:
        assert all(float(x) > 0 for x in got)

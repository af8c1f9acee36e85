"""The IoU kernel's match mode: each candidate's best gt, without the matrix.

``frcnn_targets`` reads only the row max and argmax of its masked
candidate-by-gt IoU. The port computes them in one step
(``ops/boxes.py::iou_match``; on a card the match mode of
``ops/cuda/iou.cu``, one launch for the batch) and ``train_targets`` runs
it once for the batch where each image's problem passes the JAX package's
gate. Held here:

* the plain match (``iou_match_reference``, the kernel's twin) against the
  JAX package's chain, op by op on the CPU: ``masked_iou`` (eps 1e-5:
  ``jaccard_iou``; eps 0: ``box_iou``, the 1e-12 union floor of
  ``pairwise_iou_pallas(eps=0)``), ``where(cand_valid)``, ``max`` and
  ``argmax``, on candidates with coincident gt boxes (ties: the first slot
  wins), rows with no overlap (all 0), invalid rows (all -1), zero-width
  boxes and padded gt slots, and on an image with no gt at all: the max
  bit for bit, the argmax equal;
* ``roi_match`` below the gate is the old chain in the inputs' dtype
  (bfloat16 here);
* ``train_targets`` above the gate (legacy, 512 gt slots, ``plain=True``
  on the CPU) calls the match once for the batch and gives, target for
  target, what the per-image ``propose``, ``rpn_targets`` and
  ``frcnn_targets`` give;
* on a card only (skipped here): the match mode and the matrix mode with
  both masks equal their plain twins bit for bit at the dense legacy shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.ops import boxes as jb
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models import targets as pt
from faster_rcnn_pytorch_tpu_torch.models.anchors import legacy_anchors
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import LEGACY_CONFIG
from faster_rcnn_pytorch_tpu_torch.models.rpn import propose
from faster_rcnn_pytorch_tpu_torch.ops import boxes as pb
from tests.conftest import boxes_fixture


def match_inputs(seed, n_cand=300, slots=64, real=48):
    """Candidates against padded gt in [0, 1]: the gt lies in [0, 0.5]^2,
    with slots 10-13 copies of 0-3 and slot 20 of zero width; candidates
    jittered around the gt, copies of it, zero-width ones, ones in
    [0.8, 1]^2 that meet no gt, and every 7th one invalid."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((slots, 4), np.float32)
    gt[:real] = boxes_fixture(rs, real, scale=0.5)
    gt[10:14] = gt[0:4]
    gt[20, 2] = gt[20, 0]
    gt_mask = np.zeros(slots, bool)
    gt_mask[:real] = True
    src = gt[rs.randint(0, real, n_cand)]
    size = np.tile(src[:, 2:] - src[:, :2], 2)
    cand = (src + rs.uniform(-0.3, 0.3, (n_cand, 4)) * size).astype(np.float32)
    cand[:20] = gt[rs.randint(0, real, 20)]  # coincident, ties among 0-3 / 10-13
    cand[:4] = gt[:4]
    cand[20:30, 2] = cand[20:30, 0]  # zero width
    cand[30:50] = 0.8 + boxes_fixture(rs, 20, scale=0.2)  # no overlap
    cand[50] = gt[20]  # zero width on zero width: the union floor at eps 0
    valid = np.arange(n_cand) % 7 != 3
    return cand, valid, gt, gt_mask


def jax_chain(cand, valid, gt, gt_mask, eps):
    cand, gt = jnp.asarray(cand), jnp.asarray(gt)
    if eps:
        iou = jb.masked_iou(cand, gt, jnp.asarray(gt_mask), eps=eps)
    else:
        iou = jnp.where(jnp.asarray(gt_mask)[None, :], jb.box_iou(cand, gt)[0], -1.0)
    iou = jnp.where(jnp.asarray(valid)[:, None], iou, -1.0)
    return np.asarray(iou.max(axis=1)), np.asarray(iou.argmax(axis=1)), np.asarray(iou)


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_plain_match_matches_the_jax_chain(eps):
    cand, valid, gt, gt_mask = match_inputs(0)
    want_max, want_arg, iou = jax_chain(cand, valid, gt, gt_mask, eps)
    got_max, got_arg = pb.iou_match(
        torch.tensor(cand), torch.tensor(valid), torch.tensor(gt), torch.tensor(gt_mask), eps
    )
    assert got_max.dtype == torch.float32 and got_arg.dtype == torch.int64
    np.testing.assert_array_equal(got_max.numpy(), want_max)
    np.testing.assert_array_equal(got_arg.numpy(), want_arg)
    # the inputs reach every case the kernel's reduction must get right
    ties = (iou == want_max[:, None]).sum(1) > 1
    assert (ties & (want_max > 0)).sum() >= 4 and list(want_arg[:3]) == [0, 1, 2]  # row 3 invalid
    assert (want_max[30:50][valid[30:50]] == 0).all() and (want_arg[30:50][valid[30:50]] == 0).all()
    assert (want_max[~valid] == -1).all() and (want_arg[~valid] == 0).all()
    # a batch, one image without any gt: every row -1 at slot 0
    no_gt = np.zeros_like(gt_mask)
    got_max, got_arg = pb.iou_match(
        torch.tensor(np.stack([cand, cand])), torch.tensor(np.stack([valid, valid])),
        torch.tensor(np.stack([gt, gt])), torch.tensor(np.stack([gt_mask, no_gt])), eps,
    )
    np.testing.assert_array_equal(got_max[0].numpy(), want_max)
    np.testing.assert_array_equal(got_arg[0].numpy(), want_arg)
    assert (got_max[1] == -1).all() and (got_arg[1] == 0).all()


def test_roi_match_below_the_gate_is_the_plain_chain_in_the_inputs_dtype():
    cand, valid, gt, gt_mask = match_inputs(1)
    c, g = torch.tensor(cand).bfloat16(), torch.tensor(gt).bfloat16()
    v, m = torch.tensor(valid), torch.tensor(gt_mask)
    got_max, got_arg = pt.roi_match(c, v, g, m)
    want = torch.where(v[:, None], pb.masked_iou(c, g, m), -1.0).max(dim=1)
    assert got_max.dtype == torch.bfloat16
    assert torch.equal(got_max, want.values) and torch.equal(got_arg, want.indices)


def test_train_targets_match_once_for_the_batch_as_frcnn_targets_per_image(monkeypatch):
    cfg = LEGACY_CONFIG
    slots = 512  # (2000 + 512) * 512 pairs: past the gate
    assert (cfg.post_nms_train + slots) * slots >= pb.IOU_KERNEL_MIN_PAIRS
    rs = np.random.RandomState(2)
    anchors = torch.tensor(legacy_anchors(96, 128))
    a, b = anchors.shape[0], 2
    rpn_cls = torch.tensor(rs.normal(size=(b, a, 2)).astype(np.float32))
    rpn_reg = torch.tensor(rs.normal(0, 0.2, size=(b, a, 4)).astype(np.float32))
    extents = torch.tensor([[1.0, 1.0], [0.75, 0.9]])
    gt = np.zeros((b, slots, 4), np.float32)
    gt_mask = np.zeros((b, slots), bool)
    for i, real in enumerate((300, 450)):
        gt[i, :real] = boxes_fixture(rs, real, scale=0.7)
        gt_mask[i, :real] = True
    gt_labels = torch.tensor(rs.randint(0, 20, size=(b, slots)).astype(np.int32))
    gt, gt_mask = torch.tensor(gt), torch.tensor(gt_mask)
    n_cand = cfg.post_nms_train + slots
    noise = pfr.TrainNoise(
        *(torch.tensor(rs.uniform(size=(b, n)).astype(np.float32)) for n in (a, a, n_cand, n_cand))
    )

    calls = []
    match = pb.iou_match_reference

    def spy(boxes, *args, **kwargs):
        calls.append(tuple(boxes.shape))
        return match(boxes, *args, **kwargs)

    monkeypatch.setattr(pb, "iou_match_reference", spy)
    rpn_tg, roi_tg = pfr.train_targets(
        cfg, anchors, rpn_cls, rpn_reg, extents, gt, gt_labels, gt_mask, noise, plain=True
    )
    assert calls == [(b, n_cand, 4)]
    assert int(roi_tg.is_pos.sum()) > 0
    for i in range(b):
        props = propose(
            rpn_cls[i], rpn_reg[i], anchors, extents[i], pre_k=cfg.pre_nms_train,
            post_k=cfg.post_nms_train, nms_iou=cfg.rpn_nms_iou, min_size=cfg.proposal_min_size,
            nms_tile=cfg.rpn_nms_tile_train or cfg.rpn_nms_tile,
        )
        want_roi = pt.frcnn_targets(
            props.rois, props.valid, gt[i], gt_labels[i], gt_mask[i], noise.roi_pos[i],
            noise.roi_neg[i], num_samples=cfg.roi_samples, pos_quota=cfg.roi_pos_quota,
            pos_iou=cfg.roi_pos_iou, label_offset=cfg.label_offset, plain=True,
        )
        want_rpn = pt.rpn_targets(
            anchors, gt[i], gt_mask[i], extents[i], noise.rpn_pos[i], noise.rpn_neg[i],
            pos_iou=cfg.rpn_pos_iou, neg_iou=cfg.rpn_neg_iou, pos_quota=cfg.rpn_pos_quota,
            total_quota=cfg.rpn_total_quota, allow_ties=cfg.rpn_allow_ties,
            boundary_filter=cfg.rpn_boundary_filter,
        )
        for field in pt.RoITargets._fields:
            assert torch.equal(getattr(roi_tg, field)[i], getattr(want_roi, field)), field
        for field in pt.RPNTargets._fields:
            assert torch.equal(getattr(rpn_tg, field)[i], getattr(want_rpn, field)), field
    assert len(calls) == 1 + b  # one per image for frcnn_targets, one for the batch


def test_cuda_wrappers_refuse_cpu_tensors():
    cand, valid, gt, gt_mask = (torch.tensor(x) for x in match_inputs(3))
    with pytest.raises(ValueError, match="CUDA"):
        pb.iou_match_cuda(cand[None], valid[None], gt[None], gt_mask[None])
    with pytest.raises(NotImplementedError):
        pb.iou_match(cand.to("meta"), valid.to("meta"), gt.to("meta"), gt_mask.to("meta"))


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_cuda_match_and_masked_matrix_equal_their_twins(eps):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    batch = [match_inputs(seed, n_cand=2512, slots=512, real=400) for seed in (4, 5)]
    cand, valid, gt, gt_mask = (torch.tensor(np.stack(x)).cuda() for x in zip(*batch))
    before = pb.iou_match_cuda.launches
    got = pb.iou_match(cand, valid, gt, gt_mask, eps)
    torch.cuda.synchronize()
    assert pb.iou_match_cuda.launches == before + 1
    want = pb.iou_match(cand, valid, gt, gt_mask, eps, plain=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = pb.pairwise_iou(cand[0], gt[0], eps, col_mask=gt_mask[0])
    want = pb.pairwise_iou(cand[0], gt[0], eps, plain=True, col_mask=gt_mask[0])
    assert torch.equal(got, want)

"""Seeded train batches for ``train_targets``, and what the one-image entry
points give for each of their images (``tests/test_torch_rpn_match.py``,
``tests/test_torch_iou_match.py``)."""

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models import targets as pt
from faster_rcnn_pytorch_tpu_torch.models.rpn import propose
from tests.conftest import boxes_fixture


def train_batch(cfg, anchors, slots, reals, extents, seed, scale=0.7):
    """A batch of ``len(reals)`` images with ``reals[i]`` real gt boxes in
    ``slots`` padded slots, the RPN head's outputs, the image ``extents``
    and the four noises: ``train_targets``' arguments after ``cfg`` and
    ``anchors``."""
    rs = np.random.RandomState(seed)
    a, b = anchors.shape[0], len(reals)
    rpn_cls = torch.tensor(rs.normal(size=(b, a, 2)).astype(np.float32))
    rpn_reg = torch.tensor(rs.normal(0, 0.2, size=(b, a, 4)).astype(np.float32))
    gt = np.zeros((b, slots, 4), np.float32)
    gt_mask = np.zeros((b, slots), bool)
    for i, real in enumerate(reals):
        gt[i, :real] = boxes_fixture(rs, real, scale=scale)
        gt_mask[i, :real] = True
    gt_labels = torch.tensor(rs.randint(0, 20, size=(b, slots)).astype(np.int32))
    n_cand = cfg.post_nms_train + slots
    noise = pfr.TrainNoise(
        *(torch.tensor(rs.uniform(size=(b, n)).astype(np.float32)) for n in (a, a, n_cand, n_cand))
    )
    return (rpn_cls, rpn_reg, torch.tensor(extents, dtype=torch.float32), torch.tensor(gt),
            gt_labels, torch.tensor(gt_mask), noise)


def per_image_targets(cfg, anchors, batch):
    """Image ``i``'s ``(RPNTargets, RoITargets)`` from ``propose``,
    ``rpn_targets`` and ``frcnn_targets``, one image at a time."""
    rpn_cls, rpn_reg, extents, gt, gt_labels, gt_mask, noise = batch
    for i in range(rpn_cls.shape[0]):
        props = propose(
            rpn_cls[i], rpn_reg[i], anchors, extents[i], pre_k=cfg.pre_nms_train,
            post_k=cfg.post_nms_train, nms_iou=cfg.rpn_nms_iou, min_size=cfg.proposal_min_size,
            nms_tile=cfg.rpn_nms_tile_train or cfg.rpn_nms_tile,
        )
        rpn = pt.rpn_targets(
            anchors, gt[i], gt_mask[i], extents[i], noise.rpn_pos[i], noise.rpn_neg[i],
            pos_iou=cfg.rpn_pos_iou, neg_iou=cfg.rpn_neg_iou, pos_quota=cfg.rpn_pos_quota,
            total_quota=cfg.rpn_total_quota, allow_ties=cfg.rpn_allow_ties,
            boundary_filter=cfg.rpn_boundary_filter,
        )
        roi = pt.frcnn_targets(
            props.rois, props.valid, gt[i], gt_labels[i], gt_mask[i], noise.roi_pos[i],
            noise.roi_neg[i], num_samples=cfg.roi_samples, pos_quota=cfg.roi_pos_quota,
            pos_iou=cfg.roi_pos_iou, label_offset=cfg.label_offset,
        )
        yield rpn, roi


def assert_equal_targets(got, want, i):
    """Every field of image ``i`` of the batched ``got`` equals ``want``'s,
    dtype, shape and bits."""
    for field, value in zip(want._fields, want):
        assert torch.equal(getattr(got, field)[i], value), (field, i)

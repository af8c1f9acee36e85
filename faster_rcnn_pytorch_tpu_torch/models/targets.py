"""Training target assignment, masked and fixed-shape.

Counterpart of ``faster_rcnn_pytorch_tpu/models/targets.py``, formula for
formula: padded gt slots and invalid candidates are masked (IoU -1), not
filtered out, and subsampling is the noise-keyed ranking of
:mod:`..ops.sampling`. The noise vectors are arguments; the JAX package
draws them as ``uniform(k_pos)`` / ``uniform(k_neg)`` after
``split(rng)`` of the per-image key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from faster_rcnn_pytorch_tpu_torch.ops.boxes import (
    IOU_KERNEL_MIN_PAIRS,
    encode,
    iou_match,
    masked_iou,
    rpn_match,
    xy_to_cxcy,
)
from faster_rcnn_pytorch_tpu_torch.ops.sampling import _group_rank_topk, sample_pos_neg

# Box-regression target normalisation of the RoI head.
REG_STD = (0.1, 0.1, 0.2, 0.2)


class RPNTargets(NamedTuple):
    labels: torch.Tensor  # [A] int32 in {-1, 0, 1}
    reg_targets: torch.Tensor  # [A, 4] encoded deltas (defined where labels == 1)


class RoITargets(NamedTuple):
    rois: torch.Tensor  # [S, 4] sampled rois (xyxy, canvas coords)
    labels: torch.Tensor  # [S] int32 class target, 0 = background, -1 = invalid
    reg_targets: torch.Tensor  # [S, 4] normalised encoded deltas
    is_pos: torch.Tensor  # [S] bool
    valid: torch.Tensor  # [S] bool


def anchor_inside(
    anchors: torch.Tensor, extents: torch.Tensor, boundary_filter: bool
) -> torch.Tensor:
    """``[B, A]``: with ``boundary_filter`` (legacy) the anchors of ``[A, 4]``
    that lie inside each image's ``extents [B, 2]`` (w_frac, h_frac); the
    others are ignored (-1) and never a gt's best anchor. Without it (FPN)
    every anchor."""
    if not boundary_filter:
        shape = (extents.shape[0], anchors.shape[0])
        return torch.ones(shape, dtype=torch.bool, device=anchors.device)
    return (
        (anchors[None, :, 0] >= 0.0)
        & (anchors[None, :, 1] >= 0.0)
        & (anchors[None, :, 2] <= extents[:, 0:1])
        & (anchors[None, :, 3] <= extents[:, 1:2])
    )


@torch.no_grad()
def rpn_labels(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    inside: torch.Tensor,
    iou_max: torch.Tensor,
    iou_argmax: torch.Tensor,
    best_any: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    pos_iou: float = 0.7,
    neg_iou: float = 0.3,
    pos_quota: int = 128,
    total_quota: int = 256,
) -> RPNTargets:
    """One image's labels and regression targets from its row of
    :func:`rpn_match`: labels from ``iou_max``, ``best_any`` and ``inside``
    ``[A]``, the two quotas (``pos_noise`` / ``neg_noise`` ``[A]``), and the
    deltas of the positives against their gt ``iou_argmax``."""
    a = anchors.shape[0]
    labels = torch.full((a,), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(inside & (iou_max < neg_iou) & (iou_max >= 0.0), 0, labels)
    labels = torch.where(best_any & inside, 1, labels)
    labels = torch.where(inside & (iou_max >= pos_iou), 1, labels)

    # Subsample: demote excess positives, then negatives, to ignore.
    pos_mask = labels == 1
    n_pos = pos_mask.sum()
    pos_rank = _group_rank_topk(pos_noise, pos_mask, pos_quota)
    labels = torch.where(pos_mask & (pos_rank >= pos_quota), -1, labels)
    n_pos_kept = n_pos.clamp(max=pos_quota)
    neg_mask = labels == 0
    neg_rank = _group_rank_topk(neg_noise, neg_mask, total_quota)
    labels = torch.where(neg_mask & (neg_rank >= total_quota - n_pos_kept), -1, labels)

    # The JAX package selects the matched gt with a one-hot matvec, which
    # is an exact gather.
    safe_arg = torch.where(gt_mask.any(), iou_argmax, 0)
    mx1, my1, mx2, my2 = gt_boxes[safe_arg].unbind(-1)
    ax1, ay1, ax2, ay2 = anchors.unbind(-1)
    aw = (ax2 - ax1).clamp(min=1e-8)
    ah = (ay2 - ay1).clamp(min=1e-8)
    pos = labels == 1
    tx = torch.where(pos, ((mx1 + mx2) / 2.0 - (ax1 + ax2) / 2.0) / aw, 0.0)
    ty = torch.where(pos, ((my1 + my2) / 2.0 - (ay1 + ay2) / 2.0) / ah, 0.0)
    tw = torch.where(pos, torch.log((mx2 - mx1).clamp(min=1e-8) / aw), 0.0)
    th = torch.where(pos, torch.log((my2 - my1).clamp(min=1e-8) / ah), 0.0)
    return RPNTargets(labels=labels, reg_targets=torch.stack([tx, ty, tw, th], dim=-1))


@torch.no_grad()
def rpn_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    extent: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    pos_iou: float = 0.7,
    neg_iou: float = 0.3,
    pos_quota: int = 128,
    total_quota: int = 256,
    allow_ties: bool = False,
    boundary_filter: bool = True,
) -> RPNTargets:
    """{-1, 0, 1} labels and regression targets for every anchor of one
    image: :func:`rpn_match`, then :func:`rpn_labels`.

    Args:
      anchors: ``[A, 4]`` xyxy in [0, 1] canvas coords.
      gt_boxes: ``[G, 4]`` padded gt boxes; gt_mask: ``[G]`` validity.
      extent: ``[2]`` (w_frac, h_frac); with ``boundary_filter`` anchors
        crossing it are ignored (-1) and never a gt's best anchor.
      pos_noise / neg_noise: ``[A]`` uniform noise of the two quotas.
      allow_ties: every anchor tied at a gt's max IoU is positive (the FPN
        variant); otherwise one argmax per gt (legacy).
    """
    inside = anchor_inside(anchors, extent[None], boundary_filter)
    iou_max, iou_argmax, best_any = rpn_match(
        anchors, gt_boxes[None], gt_mask[None], inside, allow_ties
    )
    return rpn_labels(
        anchors, gt_boxes, gt_mask, inside[0], iou_max[0], iou_argmax[0], best_any[0],
        pos_noise, neg_noise, pos_iou=pos_iou, neg_iou=neg_iou, pos_quota=pos_quota,
        total_quota=total_quota,
    )


@torch.no_grad()
def roi_match(
    cand: torch.Tensor,
    cand_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each candidate's best gt: ``(iou_max, iou_argmax)`` ``[..., R+G]`` of
    the masked IoU (-1 for a padded gt slot and for an invalid candidate),
    ties to the first slot, for one image ``[R+G, 4]`` or a batch ``[B,
    R+G, 4]``.

    Where an image's ``(R + G) * G`` reaches :data:`IOU_KERNEL_MIN_PAIRS`
    (the JAX package's gate: ``--max_gt`` 432 and up for legacy, 640 for
    FPN) this is the IoU kernel's match mode on a CUDA tensor, one launch
    for the batch (its plain twin on the CPU or with the test-only
    ``plain``); below it the plain chain in the inputs' dtype. Float32 on
    both sides, also under bfloat16 autocast: the proposals are decoded
    against float32 anchors and the gt comes from the loader."""
    if cand.shape[-2] * gt_boxes.shape[-2] >= IOU_KERNEL_MIN_PAIRS:
        return iou_match(cand, cand_valid, gt_boxes, gt_mask, plain=plain)
    iou = torch.where(cand_valid[..., :, None], masked_iou(cand, gt_boxes, gt_mask), -1.0)
    return iou.max(dim=-1)


@torch.no_grad()
def sample_roi_targets(
    cand: torch.Tensor,
    cand_valid: torch.Tensor,
    iou_max: torch.Tensor,
    iou_argmax: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    num_samples: int = 128,
    pos_quota: int = 32,
    pos_iou: float = 0.5,
    label_offset: int = 1,
) -> RoITargets:
    """One image's sampling half of :func:`frcnn_targets`, from
    :func:`roi_match`'s ``iou_max`` / ``iou_argmax`` of its candidates."""
    pos_mask = cand_valid & (iou_max >= pos_iou)
    neg_mask = cand_valid & (iou_max < pos_iou) & (iou_max >= 0.0)
    idx, is_pos, valid = sample_pos_neg(
        pos_noise, neg_noise, pos_mask, neg_mask, num_samples, pos_quota
    )
    sample_rois = cand[idx]
    matched = iou_argmax[idx]
    matched_label = gt_labels[matched].to(torch.int32) + label_offset
    labels = torch.where(is_pos, matched_label, 0)
    labels = torch.where(valid, labels, -1)

    std = torch.tensor(REG_STD, dtype=cand.dtype, device=cand.device)
    reg = encode(xy_to_cxcy(gt_boxes[matched]), xy_to_cxcy(sample_rois), eps=1e-8)
    reg = torch.where(is_pos[:, None], reg / std, 0.0)
    return RoITargets(
        rois=sample_rois, labels=labels, reg_targets=reg, is_pos=is_pos, valid=valid
    )


@torch.no_grad()
def frcnn_targets(
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    num_samples: int = 128,
    pos_quota: int = 32,
    pos_iou: float = 0.5,
    label_offset: int = 1,
    plain: bool = False,
) -> RoITargets:
    """Sample ``num_samples`` rois and their class and box targets:
    :func:`roi_match`, then :func:`sample_roi_targets`.

    Args:
      rois: ``[R, 4]`` proposals; the gt boxes are appended as candidates,
        so every image has positives. roi_valid: ``[R]``.
      gt_labels: ``[G]`` dataset labels, shifted by ``label_offset`` (1
        clears the legacy background slot).
      pos_noise / neg_noise: ``[R + G]`` uniform noise.
      plain: tests only: the plain match where :func:`roi_match` would
        launch the kernel.
    """
    cand = torch.cat([rois, gt_boxes], dim=0)
    cand_valid = torch.cat([roi_valid, gt_mask], dim=0)
    iou_max, iou_argmax = roi_match(cand, cand_valid, gt_boxes, gt_mask, plain=plain)
    return sample_roi_targets(
        cand, cand_valid, iou_max, iou_argmax, gt_boxes, gt_labels, pos_noise, neg_noise,
        num_samples=num_samples, pos_quota=pos_quota, pos_iou=pos_iou, label_offset=label_offset,
    )

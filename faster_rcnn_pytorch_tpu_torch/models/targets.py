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
    encode,
    masked_iou,
    masked_iou_gt_major,
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
    """{-1, 0, 1} labels and regression targets for every anchor.

    Args:
      anchors: ``[A, 4]`` xyxy in [0, 1] canvas coords.
      gt_boxes: ``[G, 4]`` padded gt boxes; gt_mask: ``[G]`` validity.
      extent: ``[2]`` (w_frac, h_frac); with ``boundary_filter`` anchors
        crossing it are ignored (-1) and never a gt's best anchor.
      pos_noise / neg_noise: ``[A]`` uniform noise of the two quotas.
      allow_ties: every anchor tied at a gt's max IoU is positive (the FPN
        variant); otherwise one argmax per gt (legacy).
    """
    a = anchors.shape[0]
    if boundary_filter:
        inside = (
            (anchors[:, 0] >= 0.0)
            & (anchors[:, 1] >= 0.0)
            & (anchors[:, 2] <= extent[0])
            & (anchors[:, 3] <= extent[1])
        )
    else:
        inside = torch.ones(a, dtype=torch.bool, device=anchors.device)

    iou = masked_iou_gt_major(gt_boxes, gt_mask, anchors)  # [G, A]
    iou = torch.where(inside[None, :], iou, -1.0)
    iou_max, iou_argmax = iou.max(dim=0)  # [A]; ties -> first index

    labels = torch.full((a,), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(inside & (iou_max < neg_iou) & (iou_max >= 0.0), 0, labels)

    per_gt_max, per_gt_argmax = iou.max(dim=1)  # [G]
    real = gt_mask & (per_gt_max > -1.0)
    if allow_ties:
        best_any = ((iou == per_gt_max[:, None]) & real[:, None]).any(dim=0)
    else:
        # amax, not an overwrite: a padded gt's argmax over an all(-1) row
        # is 0 and must not clobber a real gt whose best anchor is also 0.
        best_any = (
            torch.zeros(a, dtype=torch.int32, device=anchors.device).scatter_reduce(
                0, per_gt_argmax, real.to(torch.int32), reduce="amax"
            )
            > 0
        )
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
) -> RoITargets:
    """Sample ``num_samples`` rois and their class and box targets.

    Args:
      rois: ``[R, 4]`` proposals; the gt boxes are appended as candidates,
        so every image has positives. roi_valid: ``[R]``.
      gt_labels: ``[G]`` dataset labels, shifted by ``label_offset`` (1
        clears the legacy background slot).
      pos_noise / neg_noise: ``[R + G]`` uniform noise.
    """
    cand = torch.cat([rois, gt_boxes], dim=0)
    cand_valid = torch.cat([roi_valid, gt_mask], dim=0)

    iou = masked_iou(cand, gt_boxes, gt_mask)  # [R+G, G]
    iou = torch.where(cand_valid[:, None], iou, -1.0)
    iou_max, iou_argmax = iou.max(dim=1)

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

    std = torch.tensor(REG_STD, dtype=rois.dtype, device=rois.device)
    reg = encode(xy_to_cxcy(gt_boxes[matched]), xy_to_cxcy(sample_rois), eps=1e-8)
    reg = torch.where(is_pos[:, None], reg / std, 0.0)
    return RoITargets(
        rois=sample_rois, labels=labels, reg_targets=reg, is_pos=is_pos, valid=valid
    )

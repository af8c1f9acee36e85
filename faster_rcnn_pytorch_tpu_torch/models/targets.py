"""Training target assignment, masked and fixed-shape.

Counterpart of ``faster_rcnn_pytorch_tpu/models/targets.py``, formula for
formula: padded gt slots and invalid candidates are masked (IoU -1), not
filtered out, and subsampling is the noise-keyed ranking of
:mod:`..ops.sampling`. The noise vectors are arguments; the JAX package
draws them as ``uniform(k_pos)`` / ``uniform(k_neg)`` after
``split(rng)`` of the per-image key.

The labels and the sampling take the whole batch, ``[B, ...]``, in one
chain of ops that never waits for the device (the JAX package's ``vmap``
written out); the one-image entry points :func:`rpn_targets` and
:func:`frcnn_targets` run it on a batch of one.
"""

from __future__ import annotations

import functools
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
    labels: torch.Tensor  # [B, A] int32 in {-1, 0, 1}
    reg_targets: torch.Tensor  # [B, A, 4] encoded deltas (defined where labels == 1)


class RoITargets(NamedTuple):
    rois: torch.Tensor  # [B, S, 4] sampled rois (xyxy, canvas coords)
    labels: torch.Tensor  # [B, S] int32 class target, 0 = background, -1 = invalid
    reg_targets: torch.Tensor  # [B, S, 4] normalised encoded deltas
    is_pos: torch.Tensor  # [B, S] bool
    valid: torch.Tensor  # [B, S] bool
    # [B, S] int64: each sample's position among the candidates (None in
    # targets made elsewhere, as the parity tests' from the JAX package)
    index: torch.Tensor | None = None


def _first(targets):
    """Image 0 of batched targets: the one-image entry points' result."""
    return type(targets)(*(t[0] for t in targets))


def _take_boxes(boxes: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``boxes [B, n, 4]`` at ``index [B, m]``, row by row: ``[B, m, 4]``."""
    return boxes.gather(-2, index[..., None].expand(*index.shape, boxes.shape[-1]))


@functools.lru_cache(maxsize=None)
def _reg_std(dtype: torch.dtype, device: torch.device, std: tuple = REG_STD) -> torch.Tensor:
    """``std`` (:data:`REG_STD` unless a cascade stage gives its own) as a
    ``[4]`` tensor on ``device``, made once a dtype, device and std by
    fills: a copy from the host would wait for the stream. A divisor
    tensor, not Python numbers: CUDA divides by a Python number as a
    product with its reciprocal, which can differ in the last bit."""
    return torch.stack([torch.full((), s, dtype=dtype, device=device) for s in std])


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
    """The batch's labels and regression targets from :func:`rpn_match`'s
    rows: labels from ``iou_max``, ``best_any`` and ``inside`` ``[B, A]``,
    the two quotas of each image (``pos_noise`` / ``neg_noise`` ``[B,
    A]``), and the deltas of the positives of ``anchors [A, 4]`` against
    their gt ``iou_argmax`` of ``gt_boxes [B, G, 4]`` (``gt_mask [B,
    G]``)."""
    labels = torch.full(iou_max.shape, -1, dtype=torch.int32, device=iou_max.device)
    labels = torch.where(inside & (iou_max < neg_iou) & (iou_max >= 0.0), 0, labels)
    labels = torch.where(best_any & inside, 1, labels)
    labels = torch.where(inside & (iou_max >= pos_iou), 1, labels)

    # Subsample: demote excess positives, then negatives, to ignore.
    pos_mask = labels == 1
    n_pos_kept = pos_mask.sum(-1, keepdim=True).clamp(max=pos_quota)
    pos_rank = _group_rank_topk(pos_noise, pos_mask, pos_quota)
    labels = torch.where(pos_mask & (pos_rank >= pos_quota), -1, labels)
    neg_mask = labels == 0
    neg_rank = _group_rank_topk(neg_noise, neg_mask, total_quota)
    labels = torch.where(neg_mask & (neg_rank >= total_quota - n_pos_kept), -1, labels)

    # The JAX package selects the matched gt with a one-hot matvec, which
    # is an exact gather.
    safe_arg = torch.where(gt_mask.any(-1, keepdim=True), iou_argmax, 0)
    mx1, my1, mx2, my2 = _take_boxes(gt_boxes, safe_arg).unbind(-1)
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
    image, ``[A]`` and ``[A, 4]``: :func:`rpn_match`, then
    :func:`rpn_labels`, on a batch of one.

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
    return _first(rpn_labels(
        anchors, gt_boxes[None], gt_mask[None], inside, iou_max, iou_argmax, best_any,
        pos_noise[None], neg_noise[None], pos_iou=pos_iou, neg_iou=neg_iou,
        pos_quota=pos_quota, total_quota=total_quota,
    ))


@torch.no_grad()
def roi_match(
    cand: torch.Tensor,
    cand_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each candidate's best gt: ``(iou_max, iou_argmax)`` ``[..., R+G]`` of
    the masked IoU (-1 for a padded gt slot and for an invalid candidate),
    ties to the first slot, for one image ``[R+G, 4]`` or a batch ``[B,
    R+G, 4]``.

    Where an image's ``(R + G) * G`` reaches :data:`IOU_KERNEL_MIN_PAIRS`
    (the JAX package's gate: ``--max_gt`` 432 and up for legacy, 640 for
    FPN) this is the IoU kernel's match mode on a CUDA tensor, one launch
    for the batch (its plain twin on the CPU); below it the plain chain in
    the inputs' dtype. Float32 on both sides, also under bfloat16
    autocast: the proposals are decoded against float32 anchors and the gt
    comes from the loader."""
    if cand.shape[-2] * gt_boxes.shape[-2] >= IOU_KERNEL_MIN_PAIRS:
        return iou_match(cand, cand_valid, gt_boxes, gt_mask)
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
    reg_std: tuple = REG_STD,
) -> RoITargets:
    """The batch's sampling half of :func:`frcnn_targets`, from
    :func:`roi_match`'s ``iou_max`` / ``iou_argmax`` ``[B, R+G]`` of the
    candidates ``cand [B, R+G, 4]``, against ``gt_boxes [B, G, 4]`` and
    ``gt_labels [B, G]``, with ``pos_noise`` / ``neg_noise`` ``[B,
    R+G]``. A candidate is positive at ``iou_max >= pos_iou`` and
    negative below it; the positives' deltas are divided by ``reg_std``
    (a cascade stage gives its own threshold and stds)."""
    pos_mask = cand_valid & (iou_max >= pos_iou)
    neg_mask = cand_valid & (iou_max < pos_iou) & (iou_max >= 0.0)
    idx, is_pos, valid = sample_pos_neg(
        pos_noise, neg_noise, pos_mask, neg_mask, num_samples, pos_quota
    )
    sample_rois = _take_boxes(cand, idx)
    matched = iou_argmax.gather(-1, idx)
    matched_label = gt_labels.gather(-1, matched).to(torch.int32) + label_offset
    labels = torch.where(is_pos, matched_label, 0)
    labels = torch.where(valid, labels, -1)

    reg = encode(xy_to_cxcy(_take_boxes(gt_boxes, matched)), xy_to_cxcy(sample_rois), eps=1e-8)
    reg = torch.where(is_pos[..., None], reg / _reg_std(cand.dtype, cand.device, tuple(reg_std)), 0.0)
    return RoITargets(
        rois=sample_rois, labels=labels, reg_targets=reg, is_pos=is_pos, valid=valid, index=idx
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
) -> RoITargets:
    """Sample ``num_samples`` rois and their class and box targets for one
    image: :func:`roi_match`, then :func:`sample_roi_targets`, on a batch
    of one.

    Args:
      rois: ``[R, 4]`` proposals; the gt boxes are appended as candidates,
        so every image has positives. roi_valid: ``[R]``.
      gt_labels: ``[G]`` dataset labels, shifted by ``label_offset`` (1
        clears the legacy background slot).
      pos_noise / neg_noise: ``[R + G]`` uniform noise.
    """
    cand = torch.cat([rois, gt_boxes], dim=0)[None]
    cand_valid = torch.cat([roi_valid, gt_mask], dim=0)[None]
    gt_boxes, gt_mask = gt_boxes[None], gt_mask[None]
    iou_max, iou_argmax = roi_match(cand, cand_valid, gt_boxes, gt_mask)
    return _first(sample_roi_targets(
        cand, cand_valid, iou_max, iou_argmax, gt_boxes, gt_labels[None], pos_noise[None],
        neg_noise[None], num_samples=num_samples, pos_quota=pos_quota, pos_iou=pos_iou,
        label_offset=label_offset,
    ))

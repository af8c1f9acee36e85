"""Exact greedy NMS with the JAX package's fixed-shape contract.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/nms.py``; the JAX package
computes NMS in XLA, not in a Pallas kernel, so this is plain PyTorch.

* Output is a ``[post_k]`` index buffer (original indices in greedy,
  descending-score order) padded with -1, plus its validity, and
  optionally the kept boxes and scores.
* Suppression is ``box_iou > threshold`` (torchvision semantics).
* Invalid entries get score ``-inf``: they are never kept and suppress
  nothing.
* Ties keep input order (stable sorts throughout).

The sweep walks score-sorted tiles of ``tile`` boxes. Each tile is first
suppressed by the kept boxes of earlier tiles (those are final), then
iterated to its greedy fixpoint: ``active[j] = active0[j] and no k < j in
the tile with active[k] and iou[k, j] > thr``. The iteration converges to
the greedy answer because the dependencies run one way, in score order.
The host synchronises a few times per tile (fixpoint check, kept count),
never once per box; the sweep stops once ``post_k`` boxes are kept.
"""

from __future__ import annotations

import torch

from faster_rcnn_pytorch_tpu_torch.ops.boxes import box_iou

_NEG_INF = float("-inf")


def _tile_fixpoint(active0: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    """Greedy self-suppression inside one tile; ``over`` is the strictly
    upper-triangular ``[T, T]`` overlap matrix (row suppresses column).
    Counts its sweeps, each one host sync, in ``_tile_fixpoint.sweeps``."""
    active = active0
    for _ in range(active0.shape[0] + 1):
        _tile_fixpoint.sweeps += 1
        suppressed = (active[:, None] & over).any(dim=0)
        new = active0 & ~suppressed
        if torch.equal(new, active):
            break
        active = new
    return active


_tile_fixpoint.sweeps = 0


def _greedy_keep(boxes, valid, iou_threshold, post_k, tile):
    """Greedy keep mask ``[n]`` over score-sorted ``boxes`` (valid first in
    each tile's order), exact in its first ``post_k`` kept entries."""
    n = boxes.shape[0]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    n_tiles = -(-n // tile)
    per_tile = torch.nn.functional.pad(valid, (0, n_tiles * tile - n)).view(n_tiles, tile)
    # Valid entries from each tile on: a sweep past the last one keeps nothing.
    remaining = per_tile.sum(dim=1).flip(0).cumsum(0).flip(0).tolist()
    count = 0
    for t in range(n_tiles):
        if count >= post_k or remaining[t] == 0:
            break
        s = t * tile
        rows = boxes[s : s + tile]
        active0 = valid[s : s + tile]
        if s:
            iou, _ = box_iou(rows, boxes[:s])
            active0 = active0 & ~((iou > iou_threshold) & keep[None, :s]).any(dim=1)
        tile_iou, _ = box_iou(rows, rows)
        over = torch.triu(tile_iou > iou_threshold, diagonal=1)
        active = _tile_fixpoint(active0, over)
        keep[s : s + tile] = active
        count += int(active.sum())
    return keep


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    post_k: int,
    valid: torch.Tensor | None = None,
    tile: int = 256,
    assume_sorted: bool = False,
    return_boxes: bool = False,
):
    """Exact greedy NMS with static output shapes.

    Args:
      boxes: ``[n, 4]`` corner-form boxes (any scale).
      scores: ``[n]``; invalid entries may be anything.
      post_k: survivors returned (padded with -1).
      valid: optional ``[n]`` bool; invalid entries are never kept and
        suppress nothing.
      assume_sorted: the caller guarantees descending scores.
      return_boxes: also return the kept ``[post_k, 4]`` boxes and
        ``[post_k]`` scores (0 in padded slots).

    Returns ``(keep_idx, keep_valid[, boxes, scores])``.
    """
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    scores = torch.where(valid, scores.float(), _NEG_INF)
    if assume_sorted:
        sorted_scores = scores
        sorted_boxes = boxes.float()
        order = torch.arange(n, device=dev)
    else:
        neg, order = torch.sort(-scores, stable=True)
        sorted_scores = -neg
        sorted_boxes = boxes.float()[order]
    sorted_valid = sorted_scores > _NEG_INF

    keep = _greedy_keep(sorted_boxes, sorted_valid, iou_threshold, post_k, tile)

    # Rank of each kept box = its keep-prefix count; scatter the first
    # post_k positions into a fixed buffer (slot post_k takes the rest).
    ranks = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (ranks < post_k), ranks, post_k)
    pos = torch.full((post_k + 1,), -1, dtype=torch.int64, device=dev)
    pos.scatter_(0, slot, torch.arange(n, device=dev))
    pos = pos[:post_k]
    sel_valid = torch.arange(post_k, device=dev) < keep.sum()
    safe = torch.where(sel_valid, pos, 0)
    keep_idx = torch.where(sel_valid, order[safe], -1).to(torch.int32)
    if not return_boxes:
        return keep_idx, sel_valid
    kept_boxes = torch.where(sel_valid[:, None], sorted_boxes[safe], 0.0)
    kept_scores = torch.where(sel_valid, sorted_scores[safe], 0.0)
    return keep_idx, sel_valid, kept_boxes, kept_scores


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_threshold: float,
    post_k: int,
    valid: torch.Tensor | None = None,
    tile: int = 256,
):
    """Class-aware NMS: each class is shifted into its own cell by
    ``class * (max_coord + 1)`` before one greedy pass."""
    if valid is None:
        max_coord = boxes.max()
    else:
        max_coord = torch.where(valid[:, None], boxes, 0.0).max()
    offsets = class_ids.float()[:, None] * (max_coord + 1.0)
    return nms(boxes + offsets, scores, iou_threshold, post_k=post_k, valid=valid, tile=tile)


def _top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` order: descending, ties by lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def multiclass_nms(
    cls_boxes: torch.Tensor,
    cls_probs: torch.Tensor,
    score_threshold: float,
    iou_threshold: float,
    num_classes: int,
    per_class_k: int = 100,
    max_det: int = 100,
    tile: int = 256,
    candidate_k: int | None = None,
):
    """Per-class suppression of the test-time head for one image.

    Args:
      cls_boxes: ``[n, num_classes, 4]`` decoded boxes in [0, 1].
      cls_probs: ``[n, num_classes]`` softmax probabilities (class 0 is
        background and skipped).
      score_threshold: keep ``prob > score_threshold``.

    Returns ``boxes [max_det, 4]``, ``labels [max_det]`` (0-based
    foreground ids, -1 pad), ``scores [max_det]``, ``valid [max_det]``.

    Three regimes, as in the JAX package: one offset-trick pass over all
    (class, roi) pairs when ``n_fg * n <= 16384``; otherwise the exact
    top-K candidate pass, or the per-class pass when more than K
    candidates clear the threshold.
    """
    dev = cls_boxes.device
    n_fg = num_classes - 1
    n = cls_boxes.shape[0]
    per_class_k = min(per_class_k, max_det)
    fg_boxes = cls_boxes[:, 1:num_classes, :].transpose(0, 1)  # [C-1, n, 4]
    fg_probs = cls_probs[:, 1:num_classes].transpose(0, 1)  # [C-1, n]
    fg_valid = fg_probs > score_threshold

    def gather(flat_boxes, flat_scores, flat_labels, keep_idx, keep_valid):
        safe = torch.where(keep_valid, keep_idx, 0).long()
        return (
            torch.where(keep_valid[:, None], flat_boxes[safe], 0.0),
            torch.where(keep_valid, flat_labels[safe], -1),
            torch.where(keep_valid, flat_scores[safe], 0.0),
            keep_valid,
        )

    if n_fg * n <= 16384:
        flat_boxes = fg_boxes.reshape(-1, 4)
        flat_probs = fg_probs.reshape(-1)
        flat_labels = torch.arange(n_fg, dtype=torch.int32, device=dev).repeat_interleave(n)
        keep_idx, keep_valid = batched_nms(
            flat_boxes,
            flat_probs,
            flat_labels,
            iou_threshold,
            post_k=max_det,
            valid=fg_valid.reshape(-1),
            tile=tile,
        )
        return gather(flat_boxes, flat_probs, flat_labels, keep_idx, keep_valid)

    k_cand = candidate_k if candidate_k is not None else min(n_fg * n, max(512, 2 * max_det))
    if k_cand == n_fg * n or int(fg_valid.sum()) <= k_cand:
        flat_boxes_all = fg_boxes.reshape(-1, 4)
        flat_probs_all = torch.where(fg_valid, fg_probs, _NEG_INF).reshape(-1)
        top_s, top_i = _top_k_stable(flat_probs_all, k_cand)
        cand_boxes = flat_boxes_all[top_i]
        cand_labels = (top_i // n).to(torch.int32)
        cand_valid = torch.isfinite(top_s)
        max_coord = torch.where(cand_valid[:, None], cand_boxes, 0.0).max()
        shifted = cand_boxes + cand_labels.float()[:, None] * (max_coord + 1.0)
        keep_idx, keep_valid = nms(
            shifted,
            top_s,
            iou_threshold,
            post_k=max_det,
            valid=cand_valid,
            tile=tile,
            assume_sorted=True,
        )
        return gather(cand_boxes, top_s, cand_labels, keep_idx, keep_valid)

    boxes_k, scores_k, valid_k = [], [], []
    for c in range(n_fg):
        _, ok, kept_boxes, kept_scores = nms(
            fg_boxes[c],
            fg_probs[c],
            iou_threshold,
            post_k=per_class_k,
            valid=fg_valid[c],
            tile=tile,
            return_boxes=True,
        )
        boxes_k.append(kept_boxes)
        scores_k.append(kept_scores)
        valid_k.append(ok)
    flat_scores = torch.where(torch.cat(valid_k), torch.cat(scores_k), -1.0)
    flat_boxes = torch.cat(boxes_k)
    flat_labels = torch.arange(n_fg, dtype=torch.int32, device=dev).repeat_interleave(per_class_k)
    if flat_scores.shape[0] < max_det:
        pad = max_det - flat_scores.shape[0]
        flat_scores = torch.cat([flat_scores, flat_scores.new_full((pad,), -1.0)])
        flat_boxes = torch.cat([flat_boxes, flat_boxes.new_zeros(pad, 4)])
        flat_labels = torch.cat([flat_labels, flat_labels.new_zeros(pad)])
    top_scores, top_idx = _top_k_stable(flat_scores, max_det)
    out_valid = top_scores > 0.0
    return (
        torch.where(out_valid[:, None], flat_boxes[top_idx], 0.0),
        torch.where(out_valid, flat_labels[top_idx], -1),
        torch.where(out_valid, top_scores, 0.0),
        out_valid,
    )

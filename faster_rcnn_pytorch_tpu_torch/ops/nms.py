"""Exact greedy NMS with the JAX package's fixed-shape contract, free of
host synchronisations.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/nms.py``; the JAX package
computes NMS in XLA (a ``lax.while_loop`` over tiles), not in a Pallas
kernel.

* Output is a ``[post_k]`` index buffer (original indices in greedy,
  descending-score order) padded with -1, plus its validity, and
  optionally the kept boxes and scores.
* Suppression is ``box_iou > threshold`` (torchvision semantics).
* Invalid entries get score ``-inf``: they are never kept and suppress
  nothing.
* Ties keep input order (stable sorts throughout).

Every function here is one device program: sorts, gathers and selections
are tensor operations, and the greedy sweep itself is
:func:`nms_segments`, the ``frcnn::nms_segments`` op (``ops/library.py``)
over a batch of score-sorted segments. On a CUDA tensor it launches the
hand-written kernel (``ops/cuda/nms.cu``, :func:`nms_segments_cuda`), one
launch for every segment of the call, a thread-block cluster of
:func:`nms_plan`'s width a segment; on the CPU it runs
:func:`nms_segments_reference`, the tiled sweep below,
which synchronises with the host a few times a tile. ``tile`` sizes only
that sweep: the result does not depend on it.

The sweep walks score-sorted tiles of ``tile`` boxes. Each tile is first
suppressed by the kept boxes of earlier tiles (those are final), then
iterated to its greedy fixpoint: ``active[j] = active0[j] and no k < j in
the tile with active[k] and iou[k, j] > thr``. The iteration converges to
the greedy answer because the dependencies run one way, in score order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from faster_rcnn_pytorch_tpu_torch.ops import library  # noqa: F401  (registers frcnn::*)
from faster_rcnn_pytorch_tpu_torch.ops.boxes import box_iou
from faster_rcnn_pytorch_tpu_torch.ops.roi_pool import H100_SMS, SHARED_MEMORY_BYTES
from faster_rcnn_pytorch_tpu_torch.utils.logging import count

_NEG_INF = float("-inf")

# The kernel's launch plan (ops/cuda/nms.cu).
KERNEL_TILE = 64  # boxes a tile of the kernel
STATIC_SHARED_BYTES = 272  # the kernel's 2 x 16 hit words and two more 64-bit words
PORTABLE_WIDTH = 8  # the widest cluster every Hopper part schedules
WIDE = 16  # a non-portable cluster, where the card runs enough of them at once
MIN_SHARE = 32  # kept boxes a CTA should own before the kept list is split


class NmsPlan(NamedTuple):
    """A launch of the NMS kernel: ``width`` CTAs a segment's cluster, each
    holding ``share`` kept boxes in ``shared_bytes`` of dynamic shared
    memory."""

    width: int
    share: int
    shared_bytes: int


def nms_shared_bytes(share: int) -> int:
    """Dynamic shared memory of a CTA holding ``share`` kept boxes: each a
    float4 and its area; the tile's 64 boxes, areas, overlap rows (uint64)
    and candidate slots (one byte)."""
    return share * (16 + 4) + KERNEL_TILE * (16 + 8 + 4 + 1)


def nms_plan(segments: int, post_k: int, sms: int = H100_SMS, wide_clusters: int = 0) -> NmsPlan:
    """The cluster width for ``segments`` segments of at most ``post_k``
    kept boxes on a card of ``sms`` SMs that runs ``wide_clusters``
    16-wide clusters at once (``cudaOccupancyMaxActiveClusters``; 0 where
    it refuses them).

    The kept list is split over a cluster only where the segments leave SMs
    idle (``segments * width <= sms``) and every CTA still owns at least
    ``MIN_SHARE`` boxes (else the cluster barrier costs more than the pairs
    it spreads): 16 where every segment's cluster runs at once, else 8,
    else 1 (the per-class sites: 182 segments fill the card; the offset
    pass: 100 kept boxes). Raises where a CTA's share does not fit its
    shared memory."""
    width = 1
    for w, fits in ((WIDE, wide_clusters >= segments), (PORTABLE_WIDTH, True)):
        if fits and segments * w <= sms and post_k >= w * MIN_SHARE:
            width = w
            break
    share = -(-post_k // width)
    shared = nms_shared_bytes(share)
    if shared + STATIC_SHARED_BYTES > SHARED_MEMORY_BYTES:
        raise ValueError(
            f"nms: {post_k} kept boxes over {width} CTAs take {shared} bytes of shared memory a CTA"
        )
    return NmsPlan(width, share, shared)


@functools.lru_cache(maxsize=64)
def _card(index: int, post_k: int) -> tuple[int, int]:
    """Device ``index``'s SM count, and how many 16-wide clusters of
    ``post_k``'s share it runs at once (0 where the share does not fit)."""
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    share = -(-post_k // WIDE)
    fits = nms_shared_bytes(share) + STATIC_SHARED_BYTES <= SHARED_MEMORY_BYTES
    return (
        torch.cuda.get_device_properties(index).multi_processor_count,
        extension().nms_max_active_clusters(index, WIDE, share) if fits else 0,
    )


def launch_plan(device: torch.device, segments: int, post_k: int) -> NmsPlan:
    """:func:`nms_plan` on ``device``: its SM count, and how many 16-wide
    clusters of ``post_k``'s share it runs at once (asked once a device and
    ``post_k``; the query does not synchronise)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return nms_plan(segments, post_k, *_card(index, post_k))


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


def nms_segments_reference(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    post_k: int,
    tile: int = 256,
):
    """Plain version of the segment kernel: the tiled sweep, segment by
    segment (host syncs allowed: it runs on the CPU, or on the card as the
    path the kernel replaces).

    Args:
      boxes: ``[S, n, 4]``, each segment sorted by descending score.
      valid: ``[S, n]`` bool.

    Returns ``keep [S, post_k]`` int32, the positions of each segment's
    first ``post_k`` kept boxes in greedy order (-1 padded), and ``count
    [S]`` int32, how many there are.
    """
    s = valid.shape[0]
    dev = boxes.device
    keep = torch.full((s, post_k), -1, dtype=torch.int32, device=dev)
    count = torch.zeros(s, dtype=torch.int32, device=dev)
    boxes = boxes.float()
    for i in range(s):
        if not bool(valid[i].any()):
            continue
        pos = torch.nonzero(_greedy_keep(boxes[i], valid[i], iou_threshold, post_k, tile))
        pos = pos[:post_k, 0].to(torch.int32)
        keep[i, : pos.shape[0]] = pos
        count[i] = pos.shape[0]
    return keep, count


def nms_segments_cuda(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    post_k: int,
    width: int | None = None,
):
    """The hand-written Hopper kernel (``ops/cuda/nms.cu``), same arguments
    and results as :func:`nms_segments_reference`: every segment in one
    launch, a cluster of :func:`launch_plan`'s width a segment (``width``:
    another, for tests and timings), no host sync. Counts its launches in
    ``nms_segments_cuda.launches``."""
    if not (boxes.is_cuda and valid.is_cuda):
        raise ValueError("nms_segments_cuda needs CUDA tensors")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"want boxes [S, n, 4] and valid [S, n], got {tuple(boxes.shape)} and "
            f"{tuple(valid.shape)}"
        )
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    if width is None:
        width = launch_plan(boxes.device, boxes.shape[0], int(post_k)).width
    keep, count = extension().nms_segments(
        boxes.float().contiguous(), valid.contiguous(), float(iou_threshold), int(post_k), int(width)
    )
    nms_segments_cuda.launches += 1
    return keep, count


nms_segments_cuda.launches = 0


def nms_segments(boxes, valid, iou_threshold: float, post_k: int, tile: int = 256):
    """``frcnn::nms_segments``: the kernel on a CUDA tensor, the plain
    version on the CPU."""
    return torch.ops.frcnn.nms_segments(boxes, valid, float(iou_threshold), int(post_k), int(tile))


def _kept(sorted_boxes, sorted_valid, iou_threshold, post_k, tile):
    """Greedy survivors of ``[S, n]`` sorted segments -> ``(pos, ok)``, both
    ``[S, post_k]``: positions into the segments (0 where padded) and their
    validity."""
    keep, _ = nms_segments(sorted_boxes, sorted_valid, iou_threshold, post_k, tile)
    ok = keep >= 0
    return torch.where(ok, keep, 0).long(), ok


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [S, n, ...]`` at ``idx [S, k]`` -> ``[S, k, ...]``."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _sort_desc(scores: torch.Tensor):
    """``lax.sort(-scores, is_stable=True)`` along the last axis."""
    neg, order = torch.sort(-scores, dim=-1, stable=True)
    return -neg, order


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
        sorted_scores, order = _sort_desc(scores)
        sorted_boxes = boxes.float()[order]
    sorted_valid = sorted_scores > _NEG_INF

    pos, sel_valid = _kept(sorted_boxes[None], sorted_valid[None], iou_threshold, post_k, tile)
    pos, sel_valid = pos[0], sel_valid[0]
    keep_idx = torch.where(sel_valid, order[pos], -1).to(torch.int32)
    if not return_boxes:
        return keep_idx, sel_valid
    kept_boxes = torch.where(sel_valid[:, None], sorted_boxes[pos], 0.0)
    kept_scores = torch.where(sel_valid, sorted_scores[pos], 0.0)
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
    """``lax.top_k`` order along the last axis: descending, ties by lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _shift_by_class(boxes, labels, valid):
    """``boxes [B, k, 4]`` moved into disjoint cells, ``label * (max_coord
    + 1)`` with each image's max over its valid boxes (``batched_nms``)."""
    max_coord = torch.where(valid[..., None], boxes, 0.0).amax(dim=(1, 2))
    return boxes + labels.float()[..., None] * (max_coord + 1.0)[:, None, None]


def _pad_segments(x: torch.Tensor, length: int, value) -> torch.Tensor:
    """Pad axis 1 of ``x`` to ``length`` with ``value``."""
    pad = length - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad) + x.shape[2:], value)], 1)


def multiclass_nms_batch(
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
    """Per-class suppression of the test-time head for a batch of images,
    one NMS launch for the batch.

    Args:
      cls_boxes: ``[B, n, num_classes, 4]`` decoded boxes in [0, 1].
      cls_probs: ``[B, n, num_classes]`` softmax probabilities (class 0 is
        background and skipped).
      score_threshold: keep ``prob > score_threshold``.

    Returns ``boxes [B, max_det, 4]``, ``labels [B, max_det]`` (0-based
    foreground ids, -1 pad), ``scores [B, max_det]``, ``valid [B, max_det]``.

    Three regimes, as in the JAX package: one offset-trick pass over all
    (class, roi) pairs when ``n_fg * n <= 16384`` (a segment an image);
    otherwise the exact top-K candidate pass, or the per-class pass when
    more than K candidates clear the threshold. That choice is made per
    image on the device, as the JAX package's ``lax.cond`` makes it: both
    passes run as segments of one launch (an image's compact segment and
    its ``n_fg`` class segments, padded to one length with invalid
    entries), the pass not taken with every entry invalid, and
    ``torch.where`` picks each image's result.

    While a profiler records, the counter ``class_nms.candidates``
    (``utils/logging.py``) adds the (class, roi) pairs over the
    threshold, over the ``B`` images.
    """
    b, n = cls_probs.shape[:2]
    dev = cls_boxes.device
    n_fg = num_classes - 1
    per_class_k = min(per_class_k, max_det)
    fg_boxes = cls_boxes[:, :, 1:num_classes, :].transpose(1, 2).float()  # [B, C-1, n, 4]
    fg_probs = cls_probs[:, :, 1:num_classes].transpose(1, 2)  # [B, C-1, n]
    fg_valid = fg_probs > score_threshold
    count("class_nms.candidates", fg_valid, b)
    flat_boxes = fg_boxes.reshape(b, n_fg * n, 4)
    flat_probs = fg_probs.reshape(b, n_fg * n)
    flat_valid = fg_valid.reshape(b, n_fg * n)
    flat_labels = (torch.arange(n_fg * n, device=dev) // n).to(torch.int32)

    def gather(boxes, scores, labels, pos, ok):
        return (
            torch.where(ok[..., None], _gather_rows(boxes, pos), 0.0),
            torch.where(ok, _gather_rows(labels, pos), -1),
            torch.where(ok, _gather_rows(scores, pos), 0.0),
            ok,
        )

    if n_fg * n <= 16384:
        shifted = _shift_by_class(flat_boxes, flat_labels[None], flat_valid)
        sorted_scores, order = _sort_desc(torch.where(flat_valid, flat_probs.float(), _NEG_INF))
        pos, ok = _kept(
            _gather_rows(shifted, order), sorted_scores > _NEG_INF, iou_threshold, max_det, tile
        )
        labels = flat_labels.expand(b, -1)
        return gather(flat_boxes, flat_probs, labels, _gather_rows(order, pos), ok)

    k_cand = candidate_k if candidate_k is not None else min(n_fg * n, max(512, 2 * max_det))
    top_s, top_i = _top_k_stable(torch.where(flat_valid, flat_probs, _NEG_INF), k_cand)
    cand_boxes = _gather_rows(flat_boxes, top_i)
    cand_labels = (top_i // n).to(torch.int32)
    cand_valid = torch.isfinite(top_s)
    shifted = _shift_by_class(cand_boxes, cand_labels, cand_valid)
    if k_cand == n_fg * n:
        # top_k is a full sort: the compaction is exact for every image.
        pos, ok = _kept(shifted, cand_valid, iou_threshold, max_det, tile)
        return gather(cand_boxes, top_s, cand_labels, pos, ok)

    use_compact = fg_valid.sum(dim=(1, 2)) <= k_cand  # [B]
    class_scores, class_order = _sort_desc(torch.where(fg_valid, fg_probs.float(), _NEG_INF))
    class_boxes = _gather_rows(fg_boxes.reshape(b * n_fg, n, 4), class_order.reshape(b * n_fg, n))
    class_valid = (class_scores > _NEG_INF) & ~use_compact[:, None, None]
    length = max(n, k_cand)
    seg_boxes = torch.cat(
        [
            _pad_segments(shifted, length, 0.0)[:, None],
            _pad_segments(class_boxes, length, 0.0).reshape(b, n_fg, length, 4),
        ],
        1,
    )
    seg_valid = torch.cat(
        [
            _pad_segments(cand_valid & use_compact[:, None], length, False)[:, None],
            _pad_segments(class_valid.reshape(b * n_fg, n), length, False).reshape(b, n_fg, length),
        ],
        1,
    )
    pos, ok = _kept(
        seg_boxes.reshape(b * (1 + n_fg), length, 4),
        seg_valid.reshape(b * (1 + n_fg), length),
        iou_threshold,
        max_det,
        tile,
    )
    pos, ok = pos.reshape(b, 1 + n_fg, max_det), ok.reshape(b, 1 + n_fg, max_det)
    compact = gather(cand_boxes, top_s, cand_labels, pos[:, 0], ok[:, 0])

    # The per-class pass: each class's first per_class_k survivors, then
    # the top max_det of all of them by score.
    pos_c = pos[:, 1:, :per_class_k].reshape(b * n_fg, per_class_k)
    ok_c = ok[:, 1:, :per_class_k].reshape(b, n_fg * per_class_k)
    kept_boxes = _gather_rows(class_boxes, pos_c).reshape(b, n_fg * per_class_k, 4)
    kept_scores = _gather_rows(class_scores.reshape(b * n_fg, n), pos_c).reshape(b, -1)
    scores_k = torch.where(ok_c, kept_scores, -1.0)
    boxes_k = torch.where(ok_c[..., None], kept_boxes, 0.0)
    labels_k = (torch.arange(n_fg * per_class_k, device=dev) // per_class_k).to(torch.int32)
    labels_k = labels_k.expand(b, -1)
    if scores_k.shape[1] < max_det:
        scores_k = _pad_segments(scores_k, max_det, -1.0)
        boxes_k = _pad_segments(boxes_k, max_det, 0.0)
        labels_k = _pad_segments(labels_k, max_det, 0)
    top_scores, top_idx = _top_k_stable(scores_k, max_det)
    out_valid = top_scores > 0.0
    per_class = (
        torch.where(out_valid[..., None], _gather_rows(boxes_k, top_idx), 0.0),
        torch.where(out_valid, _gather_rows(labels_k, top_idx), -1),
        torch.where(out_valid, top_scores, 0.0),
        out_valid,
    )
    return tuple(
        torch.where(use_compact.reshape((b,) + (1,) * (c.dim() - 1)), c, p)
        for c, p in zip(compact, per_class)
    )


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
    """:func:`multiclass_nms_batch` for one image: ``cls_boxes [n,
    num_classes, 4]``, ``cls_probs [n, num_classes]`` -> ``boxes [max_det,
    4]``, ``labels``, ``scores``, ``valid [max_det]``."""
    out = multiclass_nms_batch(
        cls_boxes[None],
        cls_probs[None],
        score_threshold,
        iou_threshold,
        num_classes,
        per_class_k=per_class_k,
        max_det=max_det,
        tile=tile,
        candidate_k=candidate_k,
    )
    return tuple(t[0] for t in out)

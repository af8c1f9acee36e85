"""Box geometry primitives, broadcasting over leading dims.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/boxes.py`` with the same
formulas in the same order, so float32 results agree to the last bit
where the arithmetic allows. Boxes are ``xyxy`` corner form or ``cxcywh``
center form, normalised to [0, 1] of the canvas. :func:`masked_iou`
sends a large 2-D problem to the IoU kernel's matrix mode
(``ops/cuda/iou.cu``) on a CUDA tensor, as the JAX package sends it to its
Pallas kernel; :func:`iou_match` gives the row max and argmax of the masked
matrix (``frcnn_targets``' use of it) in the kernel's match mode, which
never writes the matrix. :func:`rpn_match` is the RPN's anchor assignment
for a batch (``ops/cuda/anchor_match.cu`` on a CUDA tensor), which never
writes the ``[G, A]`` IoU of :func:`masked_iou_gt_major` either.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension
from faster_rcnn_pytorch_tpu_torch.ops.library import use_kernel

# The anchor match kernel's launch plan (ops/cuda/anchor_match.cu).
RPN_MATCH_TILE = 128  # anchors a block holds (kTile)
RPN_MATCH_BLOCKS_PER_SM = 32  # pass-1 blocks an SM the plan aims at: two waves of 16 resident
RPN_MATCH_MIN_SHARE = 24  # gt slots a pass-1 block walks at least, where G has them
RPN_MATCH_MAX_SPLIT = 65535  # the grid's y dimension
RPN_MATCH_DENSE_SLOTS = 256  # from this many gt slots: the gt split, and every warp on the whole tile


def cxcy_to_xy(cxcy: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    xy1 = cxcy[..., :2] - cxcy[..., 2:] / 2.0
    xy2 = cxcy[..., :2] + cxcy[..., 2:] / 2.0
    return torch.cat([xy1, xy2], dim=-1)


def xy_to_cxcy(xy: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    cxcy = (xy[..., 2:] + xy[..., :2]) / 2.0
    wh = xy[..., 2:] - xy[..., :2]
    return torch.cat([cxcy, wh], dim=-1)


def encode(gt_cxywh: torch.Tensor, anc_cxywh: torch.Tensor, eps: float = 0.0):
    """Regression deltas of ``gt`` against anchors (``eps`` floors the
    anchor and gt sizes)."""
    a_wh = anc_cxywh[..., 2:]
    if eps:
        a_wh = a_wh.clamp(min=eps)
    t_xy = (gt_cxywh[..., :2] - anc_cxywh[..., :2]) / a_wh
    g_wh = gt_cxywh[..., 2:]
    if eps:
        g_wh = g_wh.clamp(min=eps)
    t_wh = torch.log(g_wh / a_wh)
    return torch.cat([t_xy, t_wh], dim=-1)


def decode(t_cxcy: torch.Tensor, anc_cxywh: torch.Tensor) -> torch.Tensor:
    """Deltas against anchors -> center-form boxes."""
    cxcy = t_cxcy[..., :2] * anc_cxywh[..., 2:] + anc_cxywh[..., :2]
    wh = torch.exp(t_cxcy[..., 2:]) * anc_cxywh[..., 2:]
    return torch.cat([cxcy, wh], dim=-1)


def box_area(xy: torch.Tensor) -> torch.Tensor:
    return (xy[..., 2] - xy[..., 0]) * (xy[..., 3] - xy[..., 1])


def _pairwise_intersection(set_1: torch.Tensor, set_2: torch.Tensor):
    lo = torch.maximum(set_1[..., :, None, :2], set_2[..., None, :, :2])
    hi = torch.minimum(set_1[..., :, None, 2:], set_2[..., None, :, 2:])
    wh = (hi - lo).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def jaccard_iou(set_1: torch.Tensor, set_2: torch.Tensor, eps: float = 1e-5):
    """Pairwise IoU with the legacy model's union-side epsilon."""
    inter = _pairwise_intersection(set_1, set_2)
    a1 = box_area(set_1)[..., :, None]
    a2 = box_area(set_2)[..., None, :]
    union = a1 + a2 - inter + eps
    return inter / union


def box_iou(set_1: torch.Tensor, set_2: torch.Tensor):
    """Pairwise ``(iou, union)`` with a 1e-12 union floor."""
    inter = _pairwise_intersection(set_1, set_2)
    a1 = box_area(set_1)[..., :, None]
    a2 = box_area(set_2)[..., None, :]
    union = a1 + a2 - inter
    iou = inter / union.clamp(min=1e-12)
    return iou, union


# masked_iou sends a 2-D problem of at least this many pairs to the IoU
# kernel, as the JAX package's masked_iou sends it to its Pallas kernel:
# frcnn_targets' (post_nms_train + max_gt) x max_gt passes it at max_gt
# >= 432 (legacy, 2432 x 432) and >= 640 (FPN, 1640 x 640).
IOU_KERNEL_MIN_PAIRS = 1 << 20


def pairwise_iou_reference(
    set_1: torch.Tensor,
    set_2: torch.Tensor,
    eps: float = 1e-5,
    col_mask: torch.Tensor | None = None,
):
    """Plain-PyTorch pairwise IoU, the twin of the kernel's matrix mode:
    ``[..., n, 4]`` x ``[..., m, 4]`` cast to float32 -> ``[..., n, m]``
    float32. ``eps > 0`` is :func:`jaccard_iou`; ``eps == 0`` is
    :func:`box_iou` (union floored at 1e-12), as the JAX package's
    ``pairwise_iou_pallas`` computes them. Then -1 where ``col_mask
    [..., m]`` is False."""
    a, b = set_1.float(), set_2.float()
    iou = box_iou(a, b)[0] if eps == 0 else jaccard_iou(a, b, eps=eps)
    if col_mask is not None:
        iou = torch.where(col_mask[..., None, :], iou, -1.0)
    return iou


def pairwise_iou_cuda(
    set_1: torch.Tensor,
    set_2: torch.Tensor,
    eps: float = 1e-5,
    col_mask: torch.Tensor | None = None,
):
    """The hand-written Hopper kernel's matrix mode (``ops/cuda/iou.cu``),
    2-D: same arguments and result as :func:`pairwise_iou_reference`. The
    binding casts, checks, allocates and launches. Counts its launches in
    ``pairwise_iou_cuda.launches``. No model path reaches it (``roi_match``
    takes the match mode above the gate): it is the TPU kernel's own
    function, behind :func:`masked_iou`'s copy of the JAX package's gate."""
    if not set_1.is_cuda:
        raise ValueError("pairwise_iou_cuda needs CUDA tensors")
    out = extension().pairwise_iou(set_1, set_2, eps, col_mask)
    pairwise_iou_cuda.launches += 1
    return out


pairwise_iou_cuda.launches = 0


def pairwise_iou(
    set_1: torch.Tensor,
    set_2: torch.Tensor,
    eps: float = 1e-5,
    col_mask: torch.Tensor | None = None,
):
    """Pairwise IoU dispatch (``ops/library.py::use_kernel``): the hand
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if use_kernel(set_1, "IoU"):
        return pairwise_iou_cuda(set_1, set_2, eps, col_mask)
    return pairwise_iou_reference(set_1, set_2, eps, col_mask)


def masked_iou(boxes: torch.Tensor, gt: torch.Tensor, gt_mask: torch.Tensor, eps: float = 1e-5):
    """IoU of ``boxes [..., n, 4]`` vs padded ``gt [..., g, 4]``; padded gt
    slots (``gt_mask`` False) get -1, so no argmax or threshold picks them.

    A 2-D problem of at least :data:`IOU_KERNEL_MIN_PAIRS` pairs goes
    through :func:`pairwise_iou` with ``gt_mask`` as its column mask (the
    kernel on a CUDA tensor; float32, as the JAX package's Pallas kernel
    casts), a smaller one through :func:`jaccard_iou` in the inputs' dtype,
    which is what the JAX package runs on the TPU below that gate.
    """
    if boxes.dim() == 2 and boxes.shape[0] * gt.shape[0] >= IOU_KERNEL_MIN_PAIRS:
        return pairwise_iou(boxes, gt, eps=eps, col_mask=gt_mask)
    iou = jaccard_iou(boxes, gt, eps=eps)
    return torch.where(gt_mask[..., None, :], iou, -1.0)


def iou_match_reference(
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    eps: float = 1e-5,
):
    """Plain twin of the kernel's match mode: ``boxes [..., n, 4]``
    (``box_valid [..., n]``) against padded ``gt [..., g, 4]`` (``gt_mask
    [..., g]``) -> ``(max, argmax)`` ``[..., n]`` of each row of
    :func:`pairwise_iou_reference` with ``gt_mask``, -1 in the rows that
    ``box_valid`` leaves out: the chain ``masked_iou``, ``where(box_valid)``,
    ``max`` that ``frcnn_targets`` runs. Ties go to the smallest index; a
    row with no valid entry gives (-1, 0)."""
    iou = pairwise_iou_reference(boxes, gt, eps, gt_mask)
    return torch.where(box_valid[..., :, None], iou, -1.0).max(dim=-1)


def iou_match_cuda(
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    eps: float = 1e-5,
):
    """The hand-written Hopper kernel's match mode (``ops/cuda/iou.cu``):
    :func:`iou_match_reference` on ``[B, n, 4]`` x ``[B, g, 4]`` (bool masks
    ``[B, n]``, ``[B, g]``) in one launch; the IoU matrix never reaches
    device memory. Counts its launches in ``iou_match_cuda.launches``."""
    if not boxes.is_cuda:
        raise ValueError("iou_match_cuda needs CUDA tensors")
    out = extension().iou_match(boxes, gt, box_valid, gt_mask, eps)
    iou_match_cuda.launches += 1
    return out


iou_match_cuda.launches = 0


def iou_match(
    boxes: torch.Tensor,
    box_valid: torch.Tensor,
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    eps: float = 1e-5,
):
    """Row max and argmax dispatch (``ops/library.py::use_kernel``),
    batched ``[B, n, 4]`` or one image's ``[n, 4]``: the match kernel on a
    CUDA tensor (one launch for the batch), the plain chain on a CPU
    tensor."""
    if use_kernel(boxes, "IoU"):
        if boxes.dim() == 2:
            best, index = iou_match_cuda(boxes[None], box_valid[None], gt[None], gt_mask[None], eps)
            return best[0], index[0]
        return iou_match_cuda(boxes, box_valid, gt, gt_mask, eps)
    return iou_match_reference(boxes, box_valid, gt, gt_mask, eps)


def masked_iou_gt_major(
    gt: torch.Tensor, gt_mask: torch.Tensor, boxes: torch.Tensor, eps: float = 1e-5
):
    """:func:`masked_iou` transposed, ``[G, N]``, computed per box
    component with the JAX package's formula order."""
    gx1, gy1, gx2, gy2 = (gt[:, i][:, None] for i in range(4))
    bx1, by1, bx2, by2 = (boxes[:, i][None, :] for i in range(4))
    iw = (torch.minimum(gx2, bx2) - torch.maximum(gx1, bx1)).clamp(min=0.0)
    ih = (torch.minimum(gy2, by2) - torch.maximum(gy1, by1)).clamp(min=0.0)
    inter = iw * ih
    union = (gx2 - gx1) * (gy2 - gy1) + (bx2 - bx1) * (by2 - by1) - inter + eps
    return torch.where(gt_mask[:, None], inter / union, -1.0)


def rpn_match_reference(
    anchors: torch.Tensor,
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    inside: torch.Tensor,
    allow_ties: bool,
    eps: float = 1e-5,
):
    """Plain twin of the anchor match kernel: per image of ``gt [B, G, 4]``
    (``gt_mask [B, G]``) against the shared ``anchors [A, 4]``, the chain
    ``rpn_targets`` runs on the ``[G, A]`` IoU of :func:`masked_iou_gt_major`
    with -1 where ``inside [B, A]`` is False. Returns ``[B, A]``:

    * ``iou_max`` and ``iou_argmax``: each anchor's max over gt and the
      first slot that reaches it ((-1, 0) where the column is all -1);
    * ``best_any``: the "allow low-quality matches" set. A gt is real where
      ``gt_mask`` holds and its max over anchors ``per_gt_max`` exceeds -1.
      With ``allow_ties`` every anchor whose IoU equals a real gt's
      ``per_gt_max`` (the FPN variant); otherwise each real gt's first
      argmax, set with an ``amax`` scatter that a padded gt's argmax 0
      cannot clobber (legacy)."""
    a = anchors.shape[0]
    outs = []
    for i in range(gt.shape[0]):
        iou = masked_iou_gt_major(gt[i], gt_mask[i], anchors, eps)  # [G, A]
        iou = torch.where(inside[i][None, :], iou, -1.0)
        iou_max, iou_argmax = iou.max(dim=0)  # ties -> first index
        per_gt_max, per_gt_argmax = iou.max(dim=1)
        real = gt_mask[i] & (per_gt_max > -1.0)
        if allow_ties:
            best_any = ((iou == per_gt_max[:, None]) & real[:, None]).any(dim=0)
        else:
            best_any = (
                torch.zeros(a, dtype=torch.int32, device=anchors.device).scatter_reduce(
                    0, per_gt_argmax, real.to(torch.int32), reduce="amax"
                )
                > 0
            )
        outs.append((iou_max, iou_argmax, best_any))
    return tuple(torch.stack(t) for t in zip(*outs))


class RpnMatchPlan(NamedTuple):
    """A call of the anchor match kernel: ``tiles`` tiles of ``tile``
    anchors an image; pass 1 runs a block per (tile, share, image), each
    walking ``share`` gt slots of ``split`` (the last may hold fewer);
    ``blocks`` pass 1's grid, ``second`` pass 2's (a block per tile and
    image); ``per_lane`` the anchors a lane holds: 1, each of a block's four
    warps a quarter of the tile and every surviving gt, or 4, every warp the
    whole tile and a quarter of the survivors."""

    tile: int
    tiles: int
    split: int
    share: int
    blocks: int
    second: int
    per_lane: int


@functools.lru_cache(maxsize=64)  # asked on every call, from the train step's host path
def rpn_match_plan(a_count: int, g_count: int, batch: int, sms: int = 132) -> RpnMatchPlan:
    """The launch plan of :func:`rpn_match_cuda` for ``a_count`` anchors
    and ``batch`` images of ``g_count`` gt slots on a card of ``sms`` SMs.

    Below ``RPN_MATCH_DENSE_SLOTS`` slots a block walks them all and a lane
    holds 1 anchor: the fewest blocks and registers for little work. From
    it (the dense scenes) a lane holds 4, so that a coarse FPN tile that
    keeps hundreds of gt is walked by four warps at once, and the gt axis
    is split where the tiles alone give fewer than
    ``RPN_MATCH_BLOCKS_PER_SM`` blocks an SM, into as many shares as make
    up that count, each of at least ``RPN_MATCH_MIN_SHARE`` slots (legacy's
    37,800 anchors at 800x1344, batch 2, 512 slots: 592 tiles, so 7 shares
    of 74; FPN's 268,569: 4198 tiles, one share). The shares cover the
    slots in order, ``share`` each."""
    tiles = -(-a_count // RPN_MATCH_TILE)
    dense = g_count >= RPN_MATCH_DENSE_SLOTS
    want = (RPN_MATCH_BLOCKS_PER_SM * sms) // max(1, tiles * batch) if dense else 1
    split = max(1, min(want, g_count // RPN_MATCH_MIN_SHARE, RPN_MATCH_MAX_SPLIT))
    share = max(1, -(-g_count // split))
    split = max(1, -(-g_count // share))
    per_lane = 4 if dense else 1
    return RpnMatchPlan(
        RPN_MATCH_TILE, tiles, split, share, tiles * split * batch, tiles * batch, per_lane
    )


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rpn_match_launch_plan(anchors: torch.Tensor, gt: torch.Tensor) -> RpnMatchPlan:
    """:func:`rpn_match_plan` for these CUDA operands on their card."""
    index = anchors.device.index if anchors.device.index is not None else torch.cuda.current_device()
    return rpn_match_plan(anchors.shape[0], gt.shape[1], gt.shape[0], _sm_count(index))


def rpn_match_cuda(
    anchors: torch.Tensor,
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    inside: torch.Tensor,
    allow_ties: bool,
    eps: float = 1e-5,
):
    """The hand-written Hopper kernel (``ops/cuda/anchor_match.cu``):
    :func:`rpn_match_reference` for the whole batch in one call, the
    ``[G, A]`` IoU never in device memory, launched as
    :func:`rpn_match_launch_plan` says. Contiguous float32 boxes and bool
    masks on one card, ``eps >= 0``; the binding raises on anything else.
    Counts its calls in ``rpn_match_cuda.launches``, one a call however
    many CUDA kernels the call runs."""
    if not anchors.is_cuda:
        raise ValueError("rpn_match_cuda needs CUDA tensors")
    plan = rpn_match_launch_plan(anchors, gt)
    out = extension().rpn_match(
        anchors, gt, gt_mask, inside, eps, allow_ties, plan.share, plan.per_lane
    )
    rpn_match_cuda.launches += 1
    return out


rpn_match_cuda.launches = 0


def rpn_match(
    anchors: torch.Tensor,
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    inside: torch.Tensor,
    allow_ties: bool = False,
    eps: float = 1e-5,
):
    """The RPN's anchor assignment of a batch, ``(iou_max, iou_argmax,
    best_any)`` ``[B, A]`` (:func:`rpn_match_reference`), dispatched by
    ``ops/library.py::use_kernel``: the kernel on a CUDA tensor at every
    size (the JAX package has no gate here), the plain chain on a CPU
    tensor."""
    if use_kernel(anchors, "anchor match"):
        return rpn_match_cuda(anchors, gt, gt_mask, inside, allow_ties, eps)
    return rpn_match_reference(anchors, gt, gt_mask, inside, allow_ties, eps)


def clip_boxes(xy: torch.Tensor, lo: float = 0.0, hi: float = 1.0):
    return xy.clamp(lo, hi)

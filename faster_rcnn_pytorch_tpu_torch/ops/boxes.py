"""Box geometry primitives, broadcasting over leading dims.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/boxes.py`` with the same
formulas in the same order, so float32 results agree to the last bit
where the arithmetic allows. Boxes are ``xyxy`` corner form or ``cxcywh``
center form, normalised to [0, 1] of the canvas.
"""

from __future__ import annotations

import torch


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


def masked_iou(boxes: torch.Tensor, gt: torch.Tensor, gt_mask: torch.Tensor, eps: float = 1e-5):
    """IoU of ``boxes [..., n, 4]`` vs padded ``gt [..., g, 4]``; padded gt
    slots (``gt_mask`` False) get -1, so no argmax or threshold picks them.

    The JAX package sends 2-D problems with ``n*g >= 2**20`` to its Pallas
    IoU kernel on a TPU; the legacy train step stays below that gate
    (``frcnn_targets`` is 2100 x 100), so the port has the plain path only.
    """
    iou = jaccard_iou(boxes, gt, eps=eps)
    return torch.where(gt_mask[..., None, :], iou, -1.0)


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


def clip_boxes(xy: torch.Tensor, lo: float = 0.0, hi: float = 1.0):
    return xy.clamp(lo, hi)

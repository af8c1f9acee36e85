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


def clip_boxes(xy: torch.Tensor, lo: float = 0.0, hi: float = 1.0):
    return xy.clamp(lo, hi)

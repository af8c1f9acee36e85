"""Region Proposal Network head and fixed-shape proposal selection.

Counterpart of ``faster_rcnn_pytorch_tpu/models/rpn.py``. The head's
parameters carry the reference names (``inter_layer``, ``cls_layer``,
``reg_layer``); its per-anchor outputs are float32 and ordered
(y, x, anchor) like the anchors, so the NCHW maps are permuted to NHWC
before the reshape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from faster_rcnn_pytorch_tpu_torch.ops.boxes import cxcy_to_xy, decode, xy_to_cxcy
from faster_rcnn_pytorch_tpu_torch.ops.nms import nms_segments


class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness (A*2) and regression (A*4)."""

    def __init__(self, num_anchors: int = 9, channels: int = 512):
        super().__init__()
        self.inter_layer = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_layer = nn.Conv2d(channels, num_anchors * 2, 1)
        self.reg_layer = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor):
        """``[B, C, h, w]`` -> ``([B, h*w*A, 2], [B, h*w*A, 4])`` float32."""
        x = torch.relu(self.inter_layer(feat))
        b = feat.shape[0]
        cls = self.cls_layer(x).permute(0, 2, 3, 1).reshape(b, -1, 2)
        reg = self.reg_layer(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return cls.float(), reg.float()


class Proposals(NamedTuple):
    rois: torch.Tensor  # [(B,) post_k, 4] xyxy in [0,1] canvas coords
    valid: torch.Tensor  # [(B,) post_k] bool
    scores: torch.Tensor  # [(B,) post_k] objectness


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s formula, exp(x - max) / sum, with a true
    division (torch's CPU softmax multiplies by the reciprocal)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


@torch.no_grad()
def propose_batch(
    rpn_cls: torch.Tensor,
    rpn_reg: torch.Tensor,
    anchors: torch.Tensor,
    extents: torch.Tensor,
    pre_k: int,
    post_k: int,
    nms_iou: float = 0.7,
    min_size: float = 1.0 / 1000.0,
    nms_tile: int = 512,
    plain: bool = False,
) -> Proposals:
    """``post_k`` proposals of each image of a batch from its per-anchor
    predictions, with one NMS launch for the batch and no host sync.

    Softmax foreground score; decode against the anchors; clip into the
    valid extent; boxes under ``min_size`` get score ``-inf``; a stable
    descending sort keeps the top ``pre_k``; greedy NMS keeps ``post_k``.

    Args:
      rpn_cls: ``[B, A, 2]`` logits. rpn_reg: ``[B, A, 4]`` deltas.
      anchors: ``[A, 4]`` xyxy in [0,1] canvas coords.
      extents: ``[B, 2]`` (w_frac, h_frac) valid extent of each image.
      plain: tests only: the plain NMS sweep on any device.

    Returns :class:`Proposals` of ``[B, post_k, ...]``.
    """
    fg = softmax(rpn_cls)[..., 1]
    boxes = cxcy_to_xy(decode(rpn_reg, xy_to_cxcy(anchors)))
    hi = torch.cat([extents, extents], dim=-1).float()
    boxes = torch.minimum(boxes.clamp(min=0.0), hi[:, None, :])

    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    ok = (ws >= min_size) & (hs >= min_size)
    score = torch.where(ok, fg, float("-inf"))

    n = score.shape[-1]
    k = min(pre_k, n)
    if n <= 65536:
        # lax.sort(is_stable=True) on -score: ties keep anchor order.
        neg, order = torch.sort(-score, dim=-1, stable=True)
        sorted_scores = -neg[:, :k]
    else:
        # lax.top_k: descending, ties by lower index.
        vals, order = torch.sort(score, dim=-1, descending=True, stable=True)
        sorted_scores = vals[:, :k]
    order = order[:, :k]
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    in_budget = sorted_scores > float("-inf")

    keep, _ = nms_segments(sorted_boxes, in_budget, nms_iou, post_k, tile=nms_tile, plain=plain)
    keep_valid = keep >= 0
    pos = torch.where(keep_valid, keep, 0).long()
    rois = torch.gather(sorted_boxes, 1, pos[..., None].expand(-1, -1, 4))
    scores = torch.gather(sorted_scores, 1, pos)
    return Proposals(
        rois=torch.where(keep_valid[..., None], rois, 0.0),
        valid=keep_valid,
        scores=torch.where(keep_valid, scores, 0.0),
    )


def propose(
    rpn_cls: torch.Tensor,
    rpn_reg: torch.Tensor,
    anchors: torch.Tensor,
    extent: torch.Tensor,
    pre_k: int,
    post_k: int,
    nms_iou: float = 0.7,
    min_size: float = 1.0 / 1000.0,
    nms_tile: int = 512,
    plain: bool = False,
) -> Proposals:
    """:func:`propose_batch` for one image: ``rpn_cls [A, 2]``, ``rpn_reg
    [A, 4]``, ``extent [2]`` -> :class:`Proposals` of ``[post_k, ...]``."""
    props = propose_batch(
        rpn_cls[None], rpn_reg[None], anchors, extent[None], pre_k, post_k,
        nms_iou=nms_iou, min_size=min_size, nms_tile=nms_tile, plain=plain,
    )
    return Proposals(*(t[0] for t in props))

"""Four-part Faster R-CNN loss, mask-based.

Counterpart of ``faster_rcnn_pytorch_tpu/models/losses.py``:

* cross-entropy ignoring label -1, averaged over the non-ignored entries,
* RPN smooth-L1 (beta 1/9) summed over positive anchors and divided by
  the number of non-ignored labels,
* RoI smooth-L1 (beta 1) on positives, divided the same way,
* total = the unweighted sum of the four terms.

Every denominator is ``max(count, 1)``, so an all-ignored batch gives 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    rpn_cls: torch.Tensor
    rpn_reg: torch.Tensor
    roi_cls: torch.Tensor
    roi_reg: torch.Tensor


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    x = (pred - target).abs()
    return torch.where(x >= beta, x - 0.5 * beta, 0.5 * x * x / beta)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over entries with ``label >= 0``."""
    valid = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    return torch.where(valid, nll, 0.0).sum() / denom


def _cls_and_reg(pred_cls, pred_reg, target_cls, target_reg, beta: float):
    cls_loss = masked_cross_entropy(pred_cls, target_cls)
    reg = smooth_l1(pred_reg, target_reg, beta).sum(dim=-1)
    denom = (target_cls >= 0).sum().clamp(min=1)
    reg_loss = torch.where(target_cls > 0, reg, 0.0).sum() / denom
    return cls_loss, reg_loss


def rpn_loss(pred_cls, pred_reg, target_cls, target_reg, beta: float = 1.0 / 9.0):
    """Objectness CE + positive-anchor regression: ``[..., A, 2]``,
    ``[..., A, 4]``, ``[..., A]``, ``[..., A, 4]``."""
    return _cls_and_reg(pred_cls, pred_reg, target_cls, target_reg, beta)


def roi_loss(pred_cls, pred_reg, target_cls, target_reg, beta: float = 1.0):
    """Head CE + regression of the row gathered at the target class:
    ``[..., S, C]``, ``[..., S, 4]``, ``[..., S]``, ``[..., S, 4]``."""
    return _cls_and_reg(pred_cls, pred_reg, target_cls, target_reg, beta)


def frcnn_loss(pred, target) -> LossBreakdown:
    """Total loss from ``(rpn_cls, rpn_reg, roi_cls, roi_reg)`` predictions
    and targets."""
    pred_rpn_cls, pred_rpn_reg, pred_roi_cls, pred_roi_reg = pred
    tg_rpn_cls, tg_rpn_reg, tg_roi_cls, tg_roi_reg = target
    rc, rr = rpn_loss(pred_rpn_cls, pred_rpn_reg, tg_rpn_cls, tg_rpn_reg)
    fc, fr = roi_loss(pred_roi_cls, pred_roi_reg, tg_roi_cls, tg_roi_reg)
    return LossBreakdown(total=rc + rr + fc + fr, rpn_cls=rc, rpn_reg=rr, roi_cls=fc, roi_reg=fr)

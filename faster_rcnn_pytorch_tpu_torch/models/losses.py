"""Four-part Faster R-CNN loss, mask-based.

Counterpart of ``faster_rcnn_pytorch_tpu/models/losses.py``:

* cross-entropy ignoring label -1, averaged over the non-ignored entries,
* RPN smooth-L1 (beta 1/9) summed over positive anchors and divided by
  the number of non-ignored labels,
* RoI smooth-L1 (beta 1) on positives, divided the same way,
* total = the unweighted sum of the four terms.

Every denominator is ``max(count, 1)``, so an all-ignored batch gives 0.

Under data parallelism the JAX loss is one mean over the global batch:
its two counts (non-ignored anchors, non-ignored RoIs) are counts over
every image of every rank. :func:`frcnn_loss` takes a ``count_reduce``
that turns this rank's counts into the global ones and returns the data
world size ``D``; each term is then ``D * local_sum / global_count``, so
DDP's average of the ranks' gradients is the gradient of the global mean.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy summed over the entries with ``label >= 0``."""
    valid = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum()


def _sums(pred_cls, pred_reg, target_cls, target_reg, beta: float):
    """The cross-entropy and the positives' smooth-L1, each summed."""
    reg = smooth_l1(pred_reg, target_reg, beta).sum(dim=-1)
    return _nll_sum(pred_cls, target_cls), torch.where(target_cls > 0, reg, 0.0).sum()


# this rank's counts [2] -> (the data group's counts [2], data world size)
CountReduce = Callable[[torch.Tensor], tuple[torch.Tensor, int]]


def frcnn_loss(pred, target, count_reduce: CountReduce | None = None) -> LossBreakdown:
    """Total loss from ``(rpn_cls, rpn_reg, roi_cls, roi_reg)`` predictions
    and targets: ``[..., A, 2]``, ``[..., A, 4]``, ``[..., S, C]``, ``[...,
    S, 4]`` (the regression row of each sample's target class) against
    ``[..., A]``, ``[..., A, 4]``, ``[..., S]``, ``[..., S, 4]``; RPN
    smooth-L1 with beta 1/9, RoI with beta 1. ``count_reduce`` (data
    parallelism) makes the two denominators global counts and scales each
    term by the data world size (module docstring)."""
    pred_rpn_cls, pred_rpn_reg, pred_roi_cls, pred_roi_reg = pred
    tg_rpn_cls, tg_rpn_reg, tg_roi_cls, tg_roi_reg = target
    counts = torch.stack([(tg_rpn_cls >= 0).sum(), (tg_roi_cls >= 0).sum()])
    scale = 1
    if count_reduce is not None:
        counts, scale = count_reduce(counts)
    counts = counts.clamp(min=1)
    rpn = _sums(pred_rpn_cls, pred_rpn_reg, tg_rpn_cls, tg_rpn_reg, 1.0 / 9.0)
    roi = _sums(pred_roi_cls, pred_roi_reg, tg_roi_cls, tg_roi_reg, 1.0)
    rc, rr = (s / counts[0] * scale for s in rpn)
    fc, fr = (s / counts[1] * scale for s in roi)
    return LossBreakdown(total=rc + rr + fc + fr, rpn_cls=rc, rpn_reg=rr, roi_cls=fc, roi_reg=fr)

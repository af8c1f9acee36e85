"""Four-part Faster R-CNN loss, mask-based, and Cascade R-CNN's.

Counterpart of ``faster_rcnn_pytorch_tpu/models/losses.py``:

* cross-entropy ignoring label -1, averaged over the non-ignored entries,
* RPN smooth-L1 (beta 1/9) summed over positive anchors and divided by
  the number of non-ignored labels,
* RoI smooth-L1 (beta 1) on positives, divided the same way,
* total = the unweighted sum of the four terms.

Cascade R-CNN has one RoI term pair a stage, each divided by its own
stage's non-ignored count, and sums them with the stage weights ``w_t``:
total = RPN terms + sum_t w_t (CE_t + SL1_t). One head is one stage of
weight 1.

Every denominator is ``max(count, 1)``, so an all-ignored batch gives 0.

Under data parallelism the JAX loss is one mean over the global batch:
its counts (non-ignored anchors, each stage's non-ignored RoIs) are
counts over every image of every rank. :func:`frcnn_loss` takes a
``count_reduce`` that turns this rank's counts into the global ones and
returns the data world size ``D``; each term is then ``D * local_sum / global_count``, so
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


# this rank's counts [1 + stages] -> (the data group's, data world size)
CountReduce = Callable[[torch.Tensor], tuple[torch.Tensor, int]]


def stage_sums(pred_cls, pred_reg, target_cls, target_reg):
    """One RoI stage's terms before the division, from ``[..., S, C]`` and
    ``[..., S, 4]`` (the regression row of each sample's target class)
    against ``[..., S]`` and ``[..., S, 4]``: the cross-entropy sum, the
    positives' smooth-L1 sum (beta 1), and the non-ignored count."""
    ce, reg = _sums(pred_cls, pred_reg, target_cls, target_reg, 1.0)
    return ce, reg, (target_cls >= 0).sum()


def frcnn_loss(
    rpn_pred, rpn_target, stages, weights=(1.0,), count_reduce: CountReduce | None = None
) -> LossBreakdown:
    """Total loss from the RPN's ``(cls, reg)`` predictions ``[..., A,
    2]``, ``[..., A, 4]`` against ``[..., A]``, ``[..., A, 4]`` (smooth-L1
    with beta 1/9) and the RoI stages' :func:`stage_sums`: the RPN's two
    terms plus ``sum_t weights[t] * (CE_t + SL1_t)``, each stage's pair
    divided by its own non-ignored count. ``roi_cls`` and ``roi_reg`` are
    the weighted sums over the stages. ``count_reduce`` (data
    parallelism) makes every denominator a global count, in one call, and
    scales each term by the data world size (module docstring)."""
    rpn_cls, rpn_reg = rpn_pred
    tg_cls, tg_reg = rpn_target
    counts = torch.stack([(tg_cls >= 0).sum(), *(n for _, _, n in stages)])
    scale = 1
    if count_reduce is not None:
        counts, scale = count_reduce(counts)
    counts = counts.clamp(min=1)
    rc, rr = (s / counts[0] * scale for s in _sums(rpn_cls, rpn_reg, tg_cls, tg_reg, 1.0 / 9.0))
    fc = fr = None
    for t, (w, (ce, reg, _)) in enumerate(zip(weights, stages)):
        c, r = (s / counts[t + 1] * scale for s in (ce, reg))
        if w != 1:
            c, r = w * c, w * r
        fc, fr = (c, r) if fc is None else (fc + c, fr + r)
    return LossBreakdown(total=rc + rr + fc + fr, rpn_cls=rc, rpn_reg=rr, roi_cls=fc, roi_reg=fr)

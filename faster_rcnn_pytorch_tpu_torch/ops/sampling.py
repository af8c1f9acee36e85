"""Fixed-size positive/negative sampling by noise-keyed ranking.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/sampling.py``. Every
candidate carries i.i.d. uniform noise; members of a group are ranked by
descending noise, and a quota keeps the lowest ranks. The noise is an
argument here (the JAX package draws it from a key inside), so a test
can hand both packages the same numbers and compare indices exactly.

Every function ranks along the last dim, each row on its own: one image's
``[n]`` or a batch's ``[B, n]`` in one chain of ops, the JAX package's
``vmap`` written out. Ties go to the lowest index, as ``jnp.argsort``
(stable) and ``lax.top_k`` do: every sort below is ``torch.sort(...,
stable=True)``, because ``torch.topk`` promises no order among ties, and
a stable sort of a batch keeps each row's order.
"""

from __future__ import annotations

import torch


def _scatter_ranks(order: torch.Tensor, n: int) -> torch.Tensor:
    """``rank[..., order[..., j]] = j`` for each of a row's
    ``order.shape[-1]`` leading positions, ``n`` elsewhere: ``[..., n]``
    int64."""
    rank = order.new_full((*order.shape[:-1], n), n)
    j = torch.arange(order.shape[-1], device=order.device)
    return rank.scatter_(-1, order, j.expand_as(order))


def _group_rank(noise: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank of each element inside its ``mask`` group by descending
    ``noise``; elements outside the group get rank ``n``. ``[..., n]`` ->
    int64 ``[..., n]``."""
    n = noise.shape[-1]
    key = torch.where(mask, noise, float("-inf"))
    _, order = torch.sort(-key, dim=-1, stable=True)
    return torch.where(mask, _scatter_ranks(order, n), n)


def _group_rank_topk(noise: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`_group_rank` exact for ranks ``< k``; every other element
    reports ``n`` (a quota ``<= k`` only ever tests ``rank < quota``)."""
    n = noise.shape[-1]
    if k >= n:
        return _group_rank(noise, mask)
    key = torch.where(mask, noise, float("-inf"))
    _, order = torch.sort(key, dim=-1, descending=True, stable=True)
    return torch.where(mask, _scatter_ranks(order[..., :k], n), n)


def sample_pos_neg(
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    pos_mask: torch.Tensor,
    neg_mask: torch.Tensor,
    num_samples: int,
    pos_quota: int,
):
    """Exactly ``num_samples`` slots a row: up to ``pos_quota`` positives,
    the rest negatives, each a uniform random subset of its group.

    Args:
      pos_noise / neg_noise: ``[..., n]`` uniform noise (the JAX package's
        ``uniform(k_pos)`` / ``uniform(k_neg)`` after ``split(rng)``).
      pos_mask / neg_mask: ``[..., n]`` bool, disjoint candidate groups.

    Returns ``idx [..., num_samples]`` int64 (positives first, then
    negatives), ``is_pos`` and ``valid`` ``[..., num_samples]`` bool
    (``valid`` is False only where the pools are too small to fill the
    budget).
    """
    n = pos_mask.shape[-1]
    n_pos = pos_mask.sum(-1, keepdim=True).clamp(max=pos_quota)
    pos_rank = _group_rank(pos_noise, pos_mask)
    neg_rank = _group_rank(neg_noise, neg_mask)
    sel_pos = pos_rank < n_pos
    sel_neg = neg_rank < (num_samples - n_pos)
    slot = torch.where(sel_pos, pos_rank, torch.where(sel_neg, n_pos + neg_rank, n))
    _, order = torch.sort(slot, dim=-1, stable=True)
    idx = order[..., :num_samples]
    taken = (sel_pos | sel_neg).gather(-1, idx)
    is_pos = sel_pos.gather(-1, idx) & taken
    return idx, is_pos, taken

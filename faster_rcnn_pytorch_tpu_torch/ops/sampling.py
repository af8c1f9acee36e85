"""Fixed-size positive/negative sampling by noise-keyed ranking.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/sampling.py``. Every
candidate carries i.i.d. uniform noise; members of a group are ranked by
descending noise, and a quota keeps the lowest ranks. The noise is an
argument here (the JAX package draws it from a key inside), so a test
can hand both packages the same numbers and compare indices exactly.

Ties go to the lowest index, as ``jnp.argsort`` (stable) and
``lax.top_k`` do: every sort below is ``torch.sort(..., stable=True)``,
because ``torch.topk`` promises no order among ties.
"""

from __future__ import annotations

import torch


def _group_rank(noise: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank of each element inside its ``mask`` group by descending
    ``noise``; elements outside the group get rank ``n``. ``[n]`` -> int64
    ``[n]``."""
    n = noise.shape[0]
    key = torch.where(mask, noise, float("-inf"))
    _, order = torch.sort(-key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=noise.device)
    return torch.where(mask, rank, n)


def _group_rank_topk(noise: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`_group_rank` exact for ranks ``< k``; every other element
    reports ``n`` (a quota ``<= k`` only ever tests ``rank < quota``)."""
    n = noise.shape[0]
    if k >= n:
        return _group_rank(noise, mask)
    key = torch.where(mask, noise, float("-inf"))
    _, order = torch.sort(key, descending=True, stable=True)
    rank = torch.full((n,), n, dtype=torch.int64, device=noise.device)
    rank[order[:k]] = torch.arange(k, device=noise.device)
    return torch.where(mask, rank, n)


def sample_pos_neg(
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    pos_mask: torch.Tensor,
    neg_mask: torch.Tensor,
    num_samples: int,
    pos_quota: int,
):
    """Exactly ``num_samples`` slots: up to ``pos_quota`` positives, the
    rest negatives, each a uniform random subset of its group.

    Args:
      pos_noise / neg_noise: ``[n]`` uniform noise (the JAX package's
        ``uniform(k_pos)`` / ``uniform(k_neg)`` after ``split(rng)``).
      pos_mask / neg_mask: ``[n]`` bool, disjoint candidate groups.

    Returns ``idx [num_samples]`` int64 (positives first, then
    negatives), ``is_pos`` and ``valid`` ``[num_samples]`` bool (``valid``
    is False only where the pools are too small to fill the budget).
    """
    n = pos_mask.shape[0]
    n_pos = pos_mask.sum().clamp(max=pos_quota)
    pos_rank = _group_rank(pos_noise, pos_mask)
    neg_rank = _group_rank(neg_noise, neg_mask)
    sel_pos = pos_rank < n_pos
    sel_neg = neg_rank < (num_samples - n_pos)
    slot = torch.where(sel_pos, pos_rank, torch.where(sel_neg, n_pos + neg_rank, n))
    _, order = torch.sort(slot, stable=True)
    idx = order[:num_samples]
    taken = (sel_pos | sel_neg)[idx]
    is_pos = sel_pos[idx] & taken
    return idx, is_pos, taken

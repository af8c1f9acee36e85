"""The comparison that decides ``correct``.

Train cells compare three numbers, each by the worst case:

* ``loss_gap``: over the first three steps, ``|L - L_ref| / |L_ref|`` of
  the total loss;
* ``grad_gap``: over the parameters (leaves), the gap between the norms of
  the first step's update direction (gradient plus weight decay, read from
  the optimizer's momentum after one step), ``|n - n_ref|``, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by weight decay alone).

Predict cells match each image's detections to the reference's (same
class, box IoU >= ``MATCH_IOU``, greedily by score) and compare
``unmatched_share`` (detections of either side without a partner, over
all of them) and ``score_gap`` (the largest score difference of a pair).
"""

from __future__ import annotations

import statistics

import numpy as np

MATCH_IOU = 0.9


def _worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    if not names:
        return 0.0
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (3 totals), ``grad`` and ``change``
    ({leaf: norm}); ``ref`` also ``raw_grad`` ({leaf: norm of the
    gradient alone})."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    med_raw = statistics.median(ref["raw_grad"].values())
    moved = {n for n, v in ref["raw_grad"].items() if v >= 1e-3 * med_raw}
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst_leaf(prog["grad"], ref["grad"]),
        "change_gap": _worst_leaf(prog["change"], ref["change"], lambda n: n in moved),
    }


def _iou(a, b):
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def match_image(prog, ref):
    """``prog``, ``ref``: ``(boxes [n, 4], labels [n], scores [n])`` numpy.
    Returns ``(pairs, unmatched, score gaps)``."""
    pb, pl, ps = prog
    rb, rl, rs = ref
    used = np.zeros(len(pl), bool)
    gaps = []
    iou = _iou(rb, pb) if len(rl) and len(pl) else np.zeros((len(rl), len(pl)))
    for i in np.argsort(-rs, kind="stable"):
        cand = np.nonzero((pl == rl[i]) & ~used & (iou[i] >= MATCH_IOU))[0]
        if cand.size:
            j = cand[np.argmax(iou[i, cand])]
            used[j] = True
            gaps.append(abs(float(ps[j]) - float(rs[i])))
    pairs = len(gaps)
    return pairs, (len(rl) - pairs) + (len(pl) - pairs), gaps


def predict_numbers(prog_images: list, ref_images: list) -> dict:
    total = unmatched = 0
    gaps = [0.0]
    for p, r in zip(prog_images, ref_images):
        pairs, miss, g = match_image(p, r)
        total += 2 * pairs + miss
        unmatched += miss
        gaps += g
    return {"unmatched_share": unmatched / max(total, 1), "score_gap": max(gaps)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value", "limit"}}`` of the numbers the
    cell's ``limits`` name: each at or under its limit (one not finite
    fails). A cell compares only the numbers it gives a limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = float(numbers[name])
        checks[name] = {"value": value, "limit": limit}
        if not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks

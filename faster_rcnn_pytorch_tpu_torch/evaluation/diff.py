"""Detection-level diff of two runs on the same images.

Used to hold the port against the JAX package (tests) and the GPU path
against the CPU path (``chip_smoke.py``): two detection sets agree when
they pair up greedily by label and IoU, with small score and box
differences.
"""

from __future__ import annotations

import numpy as np

from faster_rcnn_pytorch_tpu_torch.evaluation.voc_eval import _iou


def greedy_match(a: dict, b: dict, iou_min: float = 0.99) -> list[tuple[int, int]]:
    """Pairs ``(i, j)`` with ``a[i] ~ b[j]``: same label and IoU >=
    ``iou_min``, taken in ``a``'s score order, each ``b[j]`` used once.
    ``a`` and ``b`` hold ``boxes [n, 4]``, ``labels [n]``, ``scores [n]``."""
    b_boxes = np.asarray(b["boxes"], np.float64).reshape(-1, 4)
    b_labels = np.asarray(b["labels"])
    used = np.zeros(len(b_labels), bool)
    pairs = []
    for i in np.argsort(-np.asarray(a["scores"]), kind="stable"):
        cand = np.where((b_labels == a["labels"][i]) & ~used)[0]
        if not len(cand):
            continue
        iou = _iou(np.asarray(a["boxes"][i], np.float64), b_boxes[cand])
        k = int(np.argmax(iou))
        if iou[k] >= iou_min:
            used[cand[k]] = True
            pairs.append((int(i), int(cand[k])))
    return pairs


def detections_agree(
    a: dict, b: dict, score_tol: float, box_tol: float, min_frac: float = 0.99
) -> tuple[bool, str]:
    """Whether at least ``min_frac`` of the larger set is greedy-matched
    with score and box differences within the tolerances; plus a summary."""
    n = max(len(a["scores"]), len(b["scores"]))
    pairs = greedy_match(a, b)
    if n == 0:
        return False, "no detections to compare"
    ds = db = 0.0
    if pairs:
        i, j = (np.array(x) for x in zip(*pairs))
        ds = float(np.abs(np.asarray(a["scores"])[i] - np.asarray(b["scores"])[j]).max())
        db = float(np.abs(np.asarray(a["boxes"])[i] - np.asarray(b["boxes"])[j]).max())
    ok = len(pairs) >= min_frac * n and ds <= score_tol and db <= box_tol
    return ok, f"{len(pairs)}/{n} matched, score |d| {ds:.3g}, box |d| {db:.3g}"

"""COCO-protocol bbox evaluation in numpy.

A copy of the bbox half of ``faster_rcnn_pytorch_tpu/evaluation/coco_eval.py``
(which the port cannot import: its cross-host merge imports the JAX
package's mesh module; the port's merges over its own process group). The protocol, as pycocotools has it:

* IoU thresholds 0.50:0.05:0.95, area ranges all/small/medium/large
  (32^2 / 96^2 split), maxDets (1, 10, 100),
* crowd ground truths are ignore-matches evaluated with
  intersection-over-detection-area,
* greedy per-image matching in descending score order, preferring real
  over ignored gts, fixed 101-point interpolated PR sampling,
* the 12 standard summary stats, ``stats[0]`` = mAP@[.5:.95].

The evaluator keeps the reference wrapper's API shape:
``update(predictions)`` with ``{image_id: {"boxes","scores","labels"}}``,
then ``synchronize_between_processes`` (the data ranks' predictions
merged), ``accumulate`` / ``summarize``.
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray):
    """IoU with pycocotools crowd semantics: for crowd gt the denominator
    is the detection area only."""
    if not len(dets) or not len(gts):
        return np.zeros((len(dets), len(gts)))
    lo = np.maximum(dets[:, None, :2], gts[None, :, :2])
    hi = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-12)


def _last_argmax(values: np.ndarray) -> int:
    """argmax with later-index tie-breaking (pycocotools updates on >=)."""
    return len(values) - 1 - int(np.argmax(values[::-1]))


def _evaluate_image(
    dets, det_scores, gts, gt_crowd, gt_area, area_rng, max_det, ious=None
):
    """Match one (image, category) pair at every IoU threshold.

    ``dets``/``det_scores`` must already be sorted by descending score and
    ``ious`` (optional precomputed) aligned with that order; matching
    processes at most ``max_det`` detections. Because greedy matching
    processes detections in score order, the result for a smaller
    ``max_det`` is a prefix of the result for a larger one — callers
    evaluate once at the largest budget and slice.

    Returns dict with per-det match info and ignore masks, or None when
    nothing to evaluate.
    """
    a0, a1 = area_rng
    gt_ignore = gt_crowd | (gt_area < a0) | (gt_area > a1)
    dets = dets[:max_det]
    det_scores = det_scores[:max_det]

    if not len(dets) and not len(gts):
        return None

    if ious is None:
        ious = _iou_matrix(dets, gts, gt_crowd)
    else:
        ious = ious[:max_det]

    t_count = len(IOU_THRS)
    d_count = len(dets)
    g_count = len(gts)
    det_match = -np.ones((t_count, d_count), dtype=np.int64)
    det_ignore = np.zeros((t_count, d_count), dtype=bool)

    not_ignored = ~gt_ignore
    for ti, thr in enumerate(IOU_THRS):
        thr_eff = min(thr, 1 - 1e-10)
        gt_taken = np.zeros(g_count, dtype=bool)
        for di in range(d_count):
            row = ious[di]
            ok = (~gt_taken | gt_crowd) & (row >= thr_eff)
            # A real (non-ignored) gt wins over any ignored gt regardless
            # of IoU (pycocotools' break rule on the ignore-last order).
            pool = ok & not_ignored
            if not pool.any():
                pool = ok & gt_ignore
                if not pool.any():
                    continue
            best_g = _last_argmax(np.where(pool, row, -1.0))
            det_match[ti, di] = best_g
            det_ignore[ti, di] = gt_ignore[best_g]
            gt_taken[best_g] = True

    det_area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    out_of_range = (det_area < a0) | (det_area > a1)
    det_ignore = det_ignore | ((det_match < 0) & out_of_range[None, :])
    return {
        "det_scores": det_scores,
        "det_matched": det_match >= 0,
        "det_ignore": det_ignore,
        "num_gt": int((~gt_ignore).sum()),
    }


class CocoEvaluator:
    """Accumulates per-image predictions and computes the 12 COCO stats."""

    def __init__(self, coco_gt):
        """``coco_gt``: a ``data.coco.CocoIndex`` (``cat_ids``,
        ``img_to_anns``)."""
        self.coco = coco_gt
        self.predictions: dict[int, dict] = {}
        self.stats: np.ndarray | None = None
        self.per_class_ap: dict[int, float] = {}

    def update(self, predictions: dict[int, dict]) -> None:
        """predictions: {image_id: {"boxes" [n,4] xyxy px, "scores" [n],
        "labels" [n] category ids}} (test.py:82-88 contract)."""
        for img_id, pred in predictions.items():
            self.predictions[int(img_id)] = {
                "boxes": np.asarray(pred["boxes"], np.float64).reshape(-1, 4),
                "scores": np.asarray(pred["scores"], np.float64).reshape(-1),
                "labels": np.asarray(pred["labels"], np.int64).reshape(-1),
            }

    def synchronize_between_processes(self) -> None:
        """Merge the predictions of every data rank (each evaluated its
        rows of each batch): the reference's pickled ``all_gather``
        (``parallel.mesh.allgather_pyobj``). One process: nothing to do."""
        from faster_rcnn_pytorch_tpu_torch.parallel.mesh import allgather_pyobj

        for merged in allgather_pyobj(self.predictions):
            self.predictions.update(merged)

    def accumulate(self) -> None:
        img_ids = sorted(self.predictions)
        cat_ids = self.coco.cat_ids
        n_area = len(AREA_RANGES)
        n_md = len(MAX_DETS)
        # precision[t, r, k, a, m]; recall[t, k, a, m]
        precision = -np.ones(
            (len(IOU_THRS), len(RECALL_THRS), len(cat_ids), n_area, n_md)
        )
        recall = -np.ones((len(IOU_THRS), len(cat_ids), n_area, n_md))

        gts_by_img_cat: dict[tuple[int, int], list] = {}
        for img_id in img_ids:
            for ann in self.coco.img_to_anns.get(img_id, []):
                gts_by_img_cat.setdefault(
                    (img_id, ann["category_id"]), []
                ).append(ann)

        max_budget = max(MAX_DETS)
        for ki, cat in enumerate(cat_ids):
            # Per (image, cat): sort detections once, compute the IoU
            # matrix once; matching runs once per area range at the
            # largest maxDets budget — smaller budgets are prefixes
            # (greedy matching processes dets in score order, so later
            # dets never affect earlier ones).
            per_image = {}
            for img_id in img_ids:
                pred = self.predictions[img_id]
                sel = pred["labels"] == cat
                anns = gts_by_img_cat.get((img_id, cat), [])
                gt_boxes = np.array(
                    [
                        [a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                        for a in anns
                    ],
                    np.float64,
                ).reshape(-1, 4)
                gt_crowd = np.array(
                    [bool(a.get("iscrowd", 0)) for a in anns], bool
                )
                gt_area = np.array(
                    [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns],
                    np.float64,
                )
                boxes = pred["boxes"][sel]
                scores = pred["scores"][sel]
                order = np.argsort(-scores, kind="stable")[:max_budget]
                boxes, scores = boxes[order], scores[order]
                ious = _iou_matrix(boxes, gt_boxes, gt_crowd)
                per_image[img_id] = (
                    boxes, scores, gt_boxes, gt_crowd, gt_area, ious
                )

            for ai, (aname, arng) in enumerate(AREA_RANGES.items()):
                full_evals = {}
                for i in img_ids:
                    b, s, g, c, a, io = per_image[i]
                    full_evals[i] = _evaluate_image(
                        b, s, g, c, a, arng, max_budget, ious=io
                    )
                for mi, max_det in enumerate(MAX_DETS):
                    evals = [
                        {
                            "det_scores": e["det_scores"][:max_det],
                            "det_matched": e["det_matched"][:, :max_det],
                            "det_ignore": e["det_ignore"][:, :max_det],
                            "num_gt": e["num_gt"],
                        }
                        for e in full_evals.values()
                        if e is not None
                    ]
                    if not evals:
                        continue
                    scores = np.concatenate([e["det_scores"] for e in evals])
                    matched = np.concatenate(
                        [e["det_matched"] for e in evals], axis=1
                    )
                    ignored = np.concatenate(
                        [e["det_ignore"] for e in evals], axis=1
                    )
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    tp = np.cumsum(matched & ~ignored, axis=1).astype(float)
                    fp = np.cumsum(~matched & ~ignored, axis=1).astype(float)
                    for ti in range(len(IOU_THRS)):
                        tpc, fpc = tp[ti], fp[ti]
                        nd = len(tpc)
                        rc = tpc / npig
                        pr = tpc / np.maximum(tpc + fpc, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # precision envelope (monotone from the right)
                        q = np.zeros(len(RECALL_THRS))
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, RECALL_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self._precision = precision
        self._recall = recall

    def summarize(self) -> np.ndarray:
        p, r = self._precision, self._recall

        def ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                s = s[[int(np.argmin(np.abs(IOU_THRS - iou)))]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        self.stats = np.array(
            [
                ap(),
                ap(iou=0.5),
                ap(iou=0.75),
                ap(area="small"),
                ap(area="medium"),
                ap(area="large"),
                ar(max_det=1),
                ar(max_det=10),
                ar(max_det=100),
                ar(area="small"),
                ar(area="medium"),
                ar(area="large"),
            ]
        )
        ai = list(AREA_RANGES).index("all")
        mi = MAX_DETS.index(100)
        for ki, cat in enumerate(self.coco.cat_ids):
            s = p[:, :, ki, ai, mi]
            s = s[s > -1]
            self.per_class_ap[cat] = float(s.mean()) if s.size else -1.0
        return self.stats

    def print_summary(self) -> None:
        names = [
            "AP@[.5:.95]", "AP@.50", "AP@.75", "AP small", "AP medium",
            "AP large", "AR@1", "AR@10", "AR@100", "AR small", "AR medium",
            "AR large",
        ]
        for n, v in zip(names, self.stats):
            print(f"  {n:12s} = {v:.3f}")

"""PASCAL VOC detection AP, host-side numpy.

A copy of ``faster_rcnn_pytorch_tpu/evaluation/voc_eval.py`` plus the
VOC class list, so the port's evaluation imports nothing of the JAX
package (whose ``evaluation`` package pulls in its data loader and
Pillow). Greedy matching at IoU >= 0.5 honouring ``difficult`` flags,
each gt matched at most once, every-point interpolated AP.
"""

from __future__ import annotations

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def _iou(det: np.ndarray, gts: np.ndarray) -> np.ndarray:
    lo = np.maximum(det[:2], gts[:, :2])
    hi = np.minimum(det[2:], gts[:, 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_d = (det[2] - det[0]) * (det[3] - det[1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    return inter / np.maximum(area_d + area_g - inter, 1e-12)


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Every-point interpolated AP (the envelope integral)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(
    predictions: dict[int, dict],
    ground_truths: dict[int, dict],
    num_classes: int,
    iou_threshold: float = 0.5,
    class_names: tuple[str, ...] | None = None,
    verbose: bool = True,
) -> dict:
    """Compute per-class AP and mAP.

    Args:
      predictions: {image_id: {"boxes" [n,4] px xyxy, "scores", "labels"}}.
      ground_truths: {image_id: {"boxes", "labels", "difficult"}}.

    Returns {"map": float, "ap": {class_id: float}}.
    """
    aps = {}
    for cls in range(num_classes):
        # Gather class gts per image with used-flags.
        cls_gt = {}
        n_pos = 0
        for img_id, gt in ground_truths.items():
            sel = np.asarray(gt["labels"]) == cls
            boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[sel]
            difficult = np.asarray(gt.get("difficult", np.zeros(sel.sum(), bool)))[
                sel
            ].astype(bool)
            cls_gt[img_id] = {
                "boxes": boxes,
                "difficult": difficult,
                "used": np.zeros(len(boxes), bool),
            }
            n_pos += int((~difficult).sum())

        dets = []
        for img_id, pred in predictions.items():
            sel = np.asarray(pred["labels"]) == cls
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[sel]
            scores = np.asarray(pred["scores"], np.float64)[sel]
            for b, s in zip(boxes, scores):
                dets.append((s, img_id, b))
        dets.sort(key=lambda t: -t[0])

        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (_, img_id, box) in enumerate(dets):
            gt = cls_gt.get(img_id)
            if gt is None or not len(gt["boxes"]):
                fp[i] = 1
                continue
            ious = _iou(box, gt["boxes"])
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold:
                if gt["difficult"][j]:
                    continue  # neither TP nor FP
                if not gt["used"][j]:
                    gt["used"][j] = True
                    tp[i] = 1
                else:
                    fp[i] = 1
            else:
                fp[i] = 1

        if n_pos == 0:
            aps[cls] = float("nan")
            continue
        tpc = np.cumsum(tp)
        fpc = np.cumsum(fp)
        rec = tpc / n_pos
        prec = tpc / np.maximum(tpc + fpc, np.spacing(1))
        aps[cls] = voc_ap(rec, prec)
        if verbose and class_names:
            print(f"  {class_names[cls]:16s} AP = {aps[cls]:.4f}")

    valid = [v for v in aps.values() if not np.isnan(v)]
    mean_ap = float(np.mean(valid)) if valid else 0.0
    if verbose:
        print(f"  mAP = {mean_ap:.4f}")
    return {"map": mean_ap, "ap": aps}

"""Evaluation loop (counterpart of ``faster_rcnn_pytorch_tpu/engine/evaluate.py``).

Per batch: ``predict`` on the padded canvas -> fixed ``[B, D, 7]`` packed
detections, copied to the host once -> rescaled from canvas-normalised
to original pixel coords -> labels mapped to the dataset's ids -> the VOC
or the COCO evaluator.
"""

from __future__ import annotations

import dataclasses
import pickle
import time

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.evaluation.coco_eval import CocoEvaluator
from faster_rcnn_pytorch_tpu_torch.evaluation.voc_eval import VOC_CLASSES, voc_eval
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import predict
from faster_rcnn_pytorch_tpu_torch.serving import pack_detections


def detections_to_original_coords(packed, batch, i):
    """Packed host ``[B, D, 7]`` detections -> original-image pixel xyxy,
    labels and scores of image ``i``."""
    d = packed[i]
    valid = d[:, 6] > 0.5
    boxes = d[valid, :4]
    labels = d[valid, 4].astype(np.int64)
    scores = d[valid, 5]
    canvas_h, canvas_w = batch["image"].shape[1:3]
    rh, rw = batch["resized_hw"][i]
    oh, ow = batch["orig_hw"][i]
    scale = np.array([canvas_w * ow / rw, canvas_h * oh / rh] * 2, np.float32)
    return boxes * scale, labels, scores


def label_map_for(opts, coco_index):
    """Model 0-based foreground label -> dataset label: identity for VOC,
    COCO's contiguous-to-category table for the legacy generation, and
    ``l + 1`` for the FPN generation, whose softmax index is the raw COCO
    category id. Both CLIs use it."""
    if opts.data_type == "voc":
        return lambda l: l
    if opts.model_generation == "legacy":
        # .get(-1): a COCO-format dataset may carry fewer categories than
        # the model's slots; those map to an id no gt has.
        return lambda l: coco_index.contiguous_to_cat.get(l, -1)
    return lambda l: l + 1


def evaluate(
    model,
    cfg,
    loader,
    data_type: str = "voc",
    coco_index=None,
    label_map=None,
    score_threshold: float | None = None,
    dump_path: str | None = None,
    plain: bool = False,
    verbose: bool = True,
) -> dict:
    """Run the eval pass over ``loader`` (any object with ``.epoch(0)``
    yielding the loader's batch dicts, ``.batch_size`` and, for VOC,
    ``.records_by_id``) on the model's device.

    VOC keeps every per-class NMS survivor, like the reference's
    ``_suppress``: the budget is ``post_nms_test * (num_classes - 1)``.
    COCO keeps the protocol's ``cfg.max_detections`` (100) and scores
    against ``coco_index`` (a ``data.coco.CocoIndex``). ``label_map`` maps
    a 0-based foreground label to the dataset's id (identity when None).
    ``plain`` is for tests only (see :func:`predict`).

    Returns ``{"map", "stats", "detections", "n_images", "seconds"}``;
    ``detections`` maps image id to its original-pixel boxes, labels (in
    the dataset's ids) and scores.
    """
    if data_type == "voc":
        cfg = dataclasses.replace(
            cfg, max_detections=cfg.post_nms_test * (cfg.num_classes - 1)
        )
    elif data_type != "coco":
        raise ValueError(f"unknown data_type {data_type!r}")
    label_map = label_map or (lambda x: x)
    label_table = np.asarray([label_map(i) for i in range(cfg.num_classes - 1)], np.int64)
    device = next(model.parameters()).device

    predictions: dict[int, dict] = {}
    gts: dict[int, dict] = {}
    t0 = time.time()
    n_img = 0
    for batch in loader.epoch(0):
        images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
        extents = torch.from_numpy(batch["extent"].astype(np.float32)).to(device)
        det = predict(model, cfg, images, extents, score_threshold, plain=plain)
        packed = pack_detections(det).cpu().numpy()
        for i in range(packed.shape[0]):
            boxes, labels, scores = detections_to_original_coords(packed, batch, i)
            img_id = int(batch["image_id"][i])
            predictions[img_id] = {
                "boxes": boxes,
                "labels": label_table[labels],
                "scores": scores,
            }
            if data_type == "voc":
                rec = loader.records_by_id[img_id]
                gts[img_id] = {
                    "boxes": rec.boxes,
                    "labels": rec.labels,
                    "difficult": rec.difficult,
                }
            n_img += 1
    infer_time = time.time() - t0
    n_det = sum(len(p["scores"]) for p in predictions.values())
    print(
        f"eval inference: {n_img} images in {infer_time:.1f}s "
        f"({n_img / max(infer_time, 1e-9):.2f} img/s), "
        f"{n_det} detections above threshold",
        flush=True,
    )
    if dump_path:
        with open(dump_path, "wb") as f:
            pickle.dump({"predictions": predictions, "gts": gts}, f)
        print(f"dumped {len(predictions)} images' detections to {dump_path}", flush=True)

    if data_type == "voc":
        stats = voc_eval(
            predictions,
            gts,
            num_classes=len(VOC_CLASSES),
            class_names=VOC_CLASSES,
            verbose=verbose,
        )
        mean_ap = stats["map"]
    else:
        evaluator = CocoEvaluator(coco_index)
        evaluator.update(predictions)
        evaluator.accumulate()
        stats = evaluator.summarize()
        if verbose:
            evaluator.print_summary()
        mean_ap = float(stats[0])
    return {
        "map": mean_ap,
        "stats": stats,
        "detections": predictions,
        "n_images": n_img,
        "seconds": infer_time,
    }

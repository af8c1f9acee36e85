"""Evaluation loop (counterpart of ``faster_rcnn_pytorch_tpu/engine/evaluate.py``).

Per batch: ``predict`` on the padded canvas -> fixed ``[B, D, 7]`` packed
detections, copied to the host once -> rescaled from canvas-normalised
to original pixel coords -> labels mapped to the dataset's ids -> the VOC
or the COCO evaluator.

Under data parallelism (``parallel/mesh.py``) each rank predicts its rows
of every host batch, and the ranks' predictions (and VOC ground truths)
are merged before scoring, so every rank returns the whole set's
detections and mAP (the JAX package's SPMD eval and its cross-host merge).
With ``dtype`` the weights are cast for the pass, as the JAX ``evaluate``
casts them (``cast_inference_params``): one bfloat16 recipe for ``main``'s
per-epoch eval and the eval CLIs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.evaluation.coco_eval import CocoEvaluator
from faster_rcnn_pytorch_tpu_torch.evaluation.voc_eval import VOC_CLASSES, voc_eval
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import predict
from faster_rcnn_pytorch_tpu_torch.parallel.mesh import allgather_pyobj, layout
from faster_rcnn_pytorch_tpu_torch.serving import pack_detections
from faster_rcnn_pytorch_tpu_torch.utils.logging import print0
from faster_rcnn_pytorch_tpu_torch.utils.runtime import inference_weights


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
    max_images: int | None = None,
    max_detections: int | None = None,
    dump_path: str | None = None,
    verbose: bool = True,
    dtype: torch.dtype | None = None,
) -> dict:
    """Run the eval pass over ``loader`` (any object with ``.epoch(0)``
    yielding the loader's batch dicts, ``.batch_size`` and, for VOC,
    ``.records_by_id``) on the model's device.

    ``max_detections`` is the per-image budget. By default VOC keeps
    every per-class NMS survivor, like the reference's ``_suppress``: the
    budget is ``post_nms_test * (num_classes - 1)``; COCO keeps the
    protocol's ``cfg.max_detections`` (100) and scores against
    ``coco_index`` (a ``data.coco.CocoIndex``). ``max_images`` stops
    taking batches once the host-batch rows dispatched reach it (a batch
    that crosses it is evaluated whole; the rows are the host batch's,
    ``loader.batch_size`` a batch, so every data rank stops at the same
    batch); only the images taken are scored. ``label_map`` maps
    a 0-based foreground label to the dataset's id (identity when None).
    ``dtype``: the weights are cast to it for the pass and restored after
    it (the float32 master weights of a train run stay as they were).

    Under data parallelism the loader's host batch (``.batch_size``
    rows; ``loader.rows`` when it already yields this rank's rows) must
    divide over the host's data ranks; each rank predicts its rows.

    Returns ``{"map", "stats", "detections", "n_images", "seconds"}``;
    ``detections`` maps image id to its original-pixel boxes, labels (in
    the dataset's ids) and scores.
    """
    if data_type not in ("voc", "coco"):
        raise ValueError(f"unknown data_type {data_type!r}")
    if max_detections is None and data_type == "voc":
        max_detections = cfg.post_nms_test * (cfg.num_classes - 1)
    if max_detections is not None:
        cfg = dataclasses.replace(cfg, max_detections=max_detections)
    label_map = label_map or (lambda x: x)
    label_table = np.asarray([label_map(i) for i in range(cfg.num_classes - 1)], np.int64)
    device = next(model.parameters()).device
    lay = layout()
    n_ranks = lay.local_data_size
    if loader.batch_size % n_ranks:
        raise ValueError(
            f"SPMD eval needs the host's eval batch ({loader.batch_size}) divisible "
            f"by its {n_ranks} data ranks; set --eval_batch_size"
        )
    # This rank's rows, unless the loader already yields only them.
    rows = None
    if n_ranks > 1 and getattr(loader, "rows", None) is None:
        b = loader.batch_size // n_ranks
        rows = slice(lay.local_data_rank * b, (lay.local_data_rank + 1) * b)

    predictions: dict[int, dict] = {}
    gts: dict[int, dict] = {}
    t0 = time.time()
    n_img = 0
    for batch in _batches(loader, rows, inference_weights(model, dtype), max_images):
        images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
        extents = torch.from_numpy(batch["extent"].astype(np.float32)).to(device)
        det = predict(model, cfg, images, extents, score_threshold)
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
    if lay.distributed:
        # Merge the data ranks' shards (JAX evaluate's cross-host merge).
        shards = allgather_pyobj((predictions, gts, n_img))
        n_img = 0
        for p, g, n in shards:
            predictions.update(p)
            gts.update(g)
            n_img += n
    n_det = sum(len(p["scores"]) for p in predictions.values())
    print0(
        f"eval inference: {n_img} images in {infer_time:.1f}s "
        f"({n_img / max(infer_time, 1e-9):.2f} img/s), "
        f"{n_det} detections above threshold",
        flush=True,
    )
    if dump_path and lay.rank == 0:
        with open(dump_path, "wb") as f:
            pickle.dump({"predictions": predictions, "gts": gts}, f)
        print(f"dumped {len(predictions)} images' detections to {dump_path}", flush=True)

    if data_type == "voc":
        stats = voc_eval(
            predictions,
            gts,
            num_classes=len(VOC_CLASSES),
            class_names=VOC_CLASSES,
            verbose=verbose and lay.rank == 0,
        )
        mean_ap = stats["map"]
    else:
        evaluator = CocoEvaluator(coco_index)
        evaluator.update(predictions)
        evaluator.accumulate()
        stats = evaluator.summarize()
        if verbose and lay.rank == 0:
            evaluator.print_summary()
        mean_ap = float(stats[0])
    return {
        "map": mean_ap,
        "stats": stats,
        "detections": predictions,
        "n_images": n_img,
        "seconds": infer_time,
    }


def _batches(loader, rows: slice | None, weights, max_images: int | None):
    """The loader's batches (this rank's ``rows`` of each) inside the
    ``weights`` context: the cast weights live as long as the pass. Stops
    after the batch whose host rows bring the count to ``max_images``."""
    dispatched = 0
    with weights, contextlib.closing(loader.epoch(0)) as batches:
        for batch in batches:
            yield batch if rows is None else {k: v[rows] for k, v in batch.items()}
            dispatched += loader.batch_size
            if max_images and dispatched >= max_images:
                return

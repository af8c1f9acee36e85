"""Image-folder demo inference (counterpart of the JAX package's
``engine/demo.py``).

Glob ``demo_root/*.{demo_image_type}``, normalise without resizing, predict
at ``opts.thres``, map the boxes to pixels and clip them, draw them with
OpenCV when it imports (into ``demo_root/detection_results/``), print a
line per image and the FPS. Each image is padded to a /64-aligned canvas
with its extent, as the JAX demo pads it, so the detections compare with
the JAX demo's.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.data.loader import load_image
from faster_rcnn_pytorch_tpu_torch.data.transforms import normalize
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import predict
from faster_rcnn_pytorch_tpu_torch.utils.label_info import class_colors, class_names


def pad_to_bucket(image: np.ndarray, align: int = 64):
    """uint8 HWC -> (normalised canvas [ch, cw, 3] float32 with ch, cw the
    next multiples of ``align``, extent [2] float32 (w / cw, h / ch))."""
    h, w = image.shape[:2]
    ch = -(-h // align) * align
    cw = -(-w // align) * align
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:h, :w] = normalize(image)
    extent = np.array([w / cw, h / ch], np.float32)
    return canvas, extent


def draw_detections(image, boxes, labels, scores, names, colors):
    import cv2

    out = np.ascontiguousarray(image[:, :, ::-1])  # RGB -> BGR
    for box, lab, score in zip(boxes, labels, scores):
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        color = tuple(int(c) for c in colors[lab % len(colors)])
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        caption = f"{names[lab]}: {score:.2f}"
        (tw, th), _ = cv2.getTextSize(caption, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(out, (x1, y1 - th - 4), (x1 + tw, y1), color, -1)
        cv2.putText(
            out, caption, (x1, y1 - 2), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, cv2.LINE_AA
        )
    return out


def demo(model, cfg, opts) -> list[dict]:
    """Run an inference-ready model (``utils/runtime.prepare_for_inference``)
    over ``opts.demo_root`` on the model's device; returns per-image
    results (``path``, pixel ``boxes``, ``labels``, ``scores``)."""
    paths = sorted(glob.glob(os.path.join(opts.demo_root, f"*.{opts.demo_image_type}")))
    out_dir = os.path.join(opts.demo_root, "detection_results")
    os.makedirs(out_dir, exist_ok=True)
    names = class_names(opts.data_type, opts.model_generation)
    colors = class_colors(len(names))
    thres = opts.thres  # used as-is, like the reference
    device = next(model.parameters()).device

    results = []
    t0 = time.time()
    for n, path in enumerate(paths):
        raw = load_image(path)
        h, w = raw.shape[:2]
        canvas, extent = pad_to_bucket(raw)
        det = predict(
            model,
            cfg,
            torch.from_numpy(canvas[None]).to(device),
            torch.from_numpy(extent[None]).to(device),
            score_threshold=thres,
        )
        valid = det.valid[0].cpu().numpy()
        scale = np.array([canvas.shape[1], canvas.shape[0]] * 2, np.float32)
        boxes = det.boxes[0].cpu().numpy()[valid] * scale
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        labels = det.labels[0].cpu().numpy()[valid]
        scores = det.scores[0].cpu().numpy()[valid]
        results.append({"path": path, "boxes": boxes, "labels": labels, "scores": scores})
        print(f"{os.path.basename(path)}: {len(scores)} detections (thres={thres})", flush=True)
        if opts.demo_vis:
            try:
                import cv2
            except ImportError:
                cv2 = None
            if cv2 is not None:
                vis = draw_detections(raw, boxes, labels, scores, names, colors)
                cv2.imwrite(os.path.join(out_dir, os.path.basename(path)), vis)
        if (n + 1) % 100 == 0:
            print(f"[{n + 1}/{len(paths)}] {(n + 1) / (time.time() - t0):.2f} FPS", flush=True)
    if paths:
        fps = len(paths) / (time.time() - t0)
        print(f"demo done: {len(paths)} images, {fps:.2f} FPS", flush=True)
    return results

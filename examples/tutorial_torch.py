"""End-to-end single-image inference walkthrough of the PyTorch port.

The port's counterpart of ``examples/tutorial.py`` (the reference's
``frcnn_tutorial.py``): build the flagship VGG16 detector, load weights (a
reference ``.pth``/``.pth.tar``, or a seeded fresh init without one), run
``predict`` on one image in bfloat16 and draw the detections into
``tutorial_out.png``. It runs on CUDA card 0, or on the CPU under
``FRT_TORCH_DEVICE=cpu``.

    python examples/tutorial_torch.py [image.jpg] [checkpoint]
"""

import os
import sys

import numpy as np
import torch

# Runnable without installation: `python examples/tutorial_torch.py` puts
# examples/ (not the repo root) on sys.path.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from faster_rcnn_pytorch_tpu_torch.data.loader import load_image  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.data.transforms import normalize, resize_min_side  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.data.voc import VOC_CLASSES  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (  # noqa: E402
    build_model,
    init_detector_weights,
    predict,
)
from faster_rcnn_pytorch_tpu_torch.utils.runtime import (  # noqa: E402
    prepare_for_inference,
    select_device,
    set_numerics,
)

MIN_SIDE = 800  # the resized image's shorter side
ALIGN = 16  # the canvas is padded to a multiple of the feature stride
THRESHOLD = 0.5
DTYPE = "bfloat16"  # the JAX tutorial's, build_model's default
OUT = "tutorial_out.png"


def load_model(ckpt_path: str | None):
    """The legacy VOC detector (21 classes), float32 on the CPU: a
    reference ``.pth``/``.pth.tar`` imported whole, or else the fresh init
    seeded with 0."""
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import load_reference_weights

    model, cfg = build_model("legacy", 21)
    if ckpt_path and ckpt_path.endswith((".pth", ".pth.tar")):
        load_reference_weights(model, ckpt_path, "legacy")
        print(f"imported torch checkpoint {ckpt_path}")
    else:
        init_detector_weights(model, torch.Generator().manual_seed(0))
        print("using fresh-initialised params (random detections expected)")
    return model, cfg


def to_canvas(raw: np.ndarray):
    """uint8 HWC image -> (normalised canvas ``[ch, cw, 3]`` float32, its
    extent ``[2]`` (w / cw, h / ch), the resized ``(h, w)``): the shorter
    side resized to ``MIN_SIDE``, zero-padded to multiples of ``ALIGN``."""
    resized, _ = resize_min_side(raw, np.zeros((0, 4), np.float32), MIN_SIDE)
    h, w = resized.shape[:2]
    ch, cw = -(-h // ALIGN) * ALIGN, -(-w // ALIGN) * ALIGN
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:h, :w] = normalize(resized)
    return canvas, np.array([w / cw, h / ch], np.float32), (h, w)


def to_original(det, canvas_hw, resized_hw, raw_hw):
    """Image 0's valid detections -> boxes in the original image's pixels,
    labels (0-based VOC classes) and scores, as numpy."""
    (ch, cw), (h, w), (oh, ow) = canvas_hw, resized_hw, raw_hw
    valid = det.valid[0].cpu().numpy()
    boxes = det.boxes[0].float().cpu().numpy()[valid] * np.array([cw, ch, cw, ch])
    boxes = boxes / np.array([w, h, w, h]) * np.array([ow, oh, ow, oh])
    return boxes, det.labels[0].cpu().numpy()[valid], det.scores[0].float().cpu().numpy()[valid]


def detect_image(model, cfg, raw: np.ndarray):
    """``raw`` through :func:`to_canvas`, ``predict`` at ``THRESHOLD`` on
    the model's device, and :func:`to_original`."""
    canvas, extent, resized_hw = to_canvas(raw)
    device = next(model.parameters()).device
    det = predict(
        model,
        cfg,
        torch.from_numpy(canvas[None]).to(device),
        torch.from_numpy(extent[None]).to(device),
        THRESHOLD,
    )
    return to_original(det, canvas.shape[:2], resized_hw, raw.shape[:2])


def draw(raw, boxes, labels, scores, path: str = OUT) -> None:
    """The boxes over ``raw`` into ``path``, with the demo's OpenCV drawing
    (``engine/demo.py::draw_detections``)."""
    import cv2

    from faster_rcnn_pytorch_tpu_torch.engine.demo import draw_detections
    from faster_rcnn_pytorch_tpu_torch.utils.label_info import class_colors

    colors = class_colors(len(VOC_CLASSES))
    cv2.imwrite(path, draw_detections(raw, boxes, labels, scores, VOC_CLASSES, colors))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    image_path = argv[0] if argv else None
    ckpt_path = argv[1] if len(argv) > 1 else None

    # 1. model + weights, cast for inference on the device
    device = select_device()
    model, cfg = load_model(ckpt_path)
    model = prepare_for_inference(model, device, set_numerics(DTYPE))

    # 2. image -> padded canvas -> predict -> original pixels
    if image_path:
        raw = load_image(image_path)
    else:
        raw = np.random.RandomState(0).randint(0, 255, (480, 640, 3), np.uint8)
        print("no image given; using random noise")
    boxes, labels, scores = detect_image(model, cfg, raw)

    print(f"{len(scores)} detections")
    for b, l, s in zip(boxes, labels, scores):
        print(f"  {VOC_CLASSES[l]:12s} {s:.2f} {b.round(1)}")
    draw(raw, boxes, labels, scores)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

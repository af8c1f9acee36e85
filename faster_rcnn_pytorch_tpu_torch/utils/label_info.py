"""Class-name and colour metadata (a copy of the JAX package's
``utils/label_info.py``, over the port's ``data/voc.py`` and
``data/coco.py``): VOC 20 names, COCO 80 contiguous names, COCO 91-slot
list with N/A holes, plus deterministic per-class colours for the demo
visualiser."""

from __future__ import annotations

import numpy as np

from faster_rcnn_pytorch_tpu_torch.data.coco import COCO_80_CLASSES
from faster_rcnn_pytorch_tpu_torch.data.voc import VOC_CLASSES

# 91-slot COCO list: raw category ids 1..90 with unused slots marked N/A
# (util/label_info.py:31-46); index 0 is background.
COCO_91_CLASSES = (
    "__background__",
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "N/A", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "N/A", "backpack",
    "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "N/A", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog",
    "pizza", "donut", "cake", "chair", "couch", "potted plant", "bed",
    "N/A", "dining table", "N/A", "N/A", "toilet", "N/A", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "N/A", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


def class_names(data_type: str, generation: str = "legacy") -> tuple[str, ...]:
    if data_type == "voc":
        return VOC_CLASSES
    if generation == "legacy":
        return COCO_80_CLASSES
    return COCO_91_CLASSES


def class_colors(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] uint8 BGR colours, deterministic."""
    rs = np.random.RandomState(seed)
    return rs.randint(50, 255, size=(n, 3), dtype=np.uint8)

"""4-image mosaic augmentation (reference: datasets/mosaic_transform.py).

Stitches four resized/cropped images into a ``2s x 2s`` canvas with
per-quadrant box shifts (datasets/mosaic_transform.py:70-91). Triggered
with p=0.5 when the ``mosaic_transform`` flag is on
(datasets/voc_dataset.py:145-156).
"""

from __future__ import annotations

import numpy as np

from faster_rcnn_pytorch_tpu_torch.data.transforms import (
    random_crop,
    resize_min_side,
)


def _prep_quadrant(image, boxes, labels, size, rng):
    """Resize -> random square-ish crop -> resize to (size, size)."""
    image, boxes = resize_min_side(image, boxes, size, max_size=1333)
    if min(image.shape[:2]) > 384:
        image, boxes, labels = random_crop(
            image, boxes, labels, rng, 384, size
        )
    h, w = image.shape[:2]
    image, boxes = resize_min_side(image, boxes, size, max_size=size)
    # Force exact (size, size) by final stretch.
    from PIL import Image as PILImage

    if image.shape[:2] != (size, size):
        sh, sw = image.shape[:2]
        image = np.asarray(
            PILImage.fromarray(image).resize((size, size), PILImage.BILINEAR)
        )
        if len(boxes):
            boxes = boxes * np.array(
                [size / sw, size / sh, size / sw, size / sh], np.float32
            )
    return image, boxes, labels


def load_mosaic(
    items: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    size: int,
    rng: np.random.RandomState,
):
    """Compose 4 (image, boxes, labels) items into one 2s x 2s mosaic.

    Returns (canvas uint8 [2s,2s,3], boxes, labels).
    """
    assert len(items) == 4
    canvas = np.zeros((2 * size, 2 * size, 3), np.uint8)
    all_boxes, all_labels = [], []
    offsets = [(0, 0), (0, size), (size, 0), (size, size)]  # (top, left)
    for (image, boxes, labels), (top, left) in zip(items, offsets):
        image, boxes, labels = _prep_quadrant(image, boxes, labels, size, rng)
        canvas[top : top + size, left : left + size] = image
        if len(boxes):
            all_boxes.append(boxes + np.array([left, top, left, top], np.float32))
            all_labels.append(labels)
    boxes = (
        np.concatenate(all_boxes, 0)
        if all_boxes
        else np.zeros((0, 4), np.float32)
    )
    labels = (
        np.concatenate(all_labels, 0) if all_labels else np.zeros((0,), np.int32)
    )
    return canvas, boxes, labels

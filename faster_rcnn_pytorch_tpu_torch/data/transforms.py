"""Host-side image/box augmentations (numpy + PIL).

Functional counterparts of the reference transform zoo
(datasets/transforms_.py and new_datasets/transforms.py), operating on
``(np.uint8 HWC image, float32 [n,4] pixel-xyxy boxes, int32 [n] labels)``
triples. The device never sees augmentation logic — only the final
normalised padded canvas (SURVEY.md §7 "host side stays host side").

Key reference semantics preserved:

* ``resize_``: scale so min side == size, capped so max side <= 1333
  (datasets/transforms_.py:61-127),
* ``hflip_`` mirrors boxes,
* ``photometric_distort_``: brightness/contrast/saturation/hue jitter
  (datasets/transforms_.py:38-58),
* ``zoom_out_``: paste into a mean-pixel canvas up to 4x
  (datasets/transforms_.py:130-147),
* ``crop_``: random crop keeping boxes with >= 0.3 of their area inside
  (datasets/transforms_.py:150-178),
* normalisation divides by ImageNet stats; the box-to-[0,1] step happens
  in the loader against the *canvas* (the reference normalises against
  the image, datasets/transforms_.py:307-316 — the canvas is the image as
  far as the device is concerned).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def hflip(image: np.ndarray, boxes: np.ndarray):
    h, w = image.shape[:2]
    image = image[:, ::-1]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return np.ascontiguousarray(image), boxes


def resize_min_side(
    image: np.ndarray, boxes: np.ndarray, size: int, max_size: int = 1333
):
    """Aspect-preserving resize: min side -> ``size``, max side capped."""
    h, w = image.shape[:2]
    scale = size / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    pil = Image.fromarray(image).resize((new_w, new_h), Image.BILINEAR)
    out = np.asarray(pil)
    if len(boxes):
        boxes = boxes * np.array(
            [new_w / w, new_h / h, new_w / w, new_h / h], np.float32
        )
    return out, boxes


def photometric_distort(
    image: np.ndarray, rng: np.random.RandomState, delta: float = 18.0
):
    """Reference ``photometric_distort_`` parity (transforms_.py:38-58):
    ALL FOUR of brightness / contrast / saturation / hue are applied, in
    random order, with factors U(0.5, 1.5) (hue: U(-18/255, 18/255) of a
    cycle). torchvision's PIL backend implements the first three via
    ``ImageEnhance`` and hue via an HSV channel roll — used verbatim
    here, so the pixel math is identical, not an approximation.
    """
    from PIL import ImageEnhance

    def brightness(im):
        return ImageEnhance.Brightness(im).enhance(rng.uniform(0.5, 1.5))

    def contrast(im):
        return ImageEnhance.Contrast(im).enhance(rng.uniform(0.5, 1.5))

    def saturation(im):
        return ImageEnhance.Color(im).enhance(rng.uniform(0.5, 1.5))

    def hue(im):
        f = rng.uniform(-delta / 255.0, delta / 255.0)
        hsv = np.asarray(im.convert("HSV"), np.int16).copy()
        hsv[..., 0] = (hsv[..., 0] + int(f * 255)) % 256
        return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

    ops = [brightness, contrast, saturation, hue]
    img = Image.fromarray(image)
    for i in rng.permutation(4):
        img = ops[i](img)
    return np.asarray(img, np.uint8)


def zoom_out(
    image: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.RandomState,
    max_scale: float = 4.0,
):
    """Paste into a larger mean-colour canvas (expands small objects'
    relative share of scale space)."""
    h, w = image.shape[:2]
    scale = rng.uniform(1.0, max_scale)
    nh, nw = int(h * scale), int(w * scale)
    top = rng.randint(0, nh - h + 1)
    left = rng.randint(0, nw - w + 1)
    canvas = np.empty((nh, nw, 3), np.uint8)
    canvas[:] = (IMAGENET_MEAN * 255).astype(np.uint8)
    canvas[top : top + h, left : left + w] = image
    if len(boxes):
        boxes = boxes + np.array([left, top, left, top], np.float32)
    return canvas, boxes


def random_crop(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    rng: np.random.RandomState,
    min_size: int,
    max_size: int,
    keep_overlap: float = 0.3,
):
    """Random crop; keep boxes with >= ``keep_overlap`` of area inside."""
    h, w = image.shape[:2]
    cw = rng.randint(min(min_size, w), min(max_size, w) + 1)
    ch = rng.randint(min(min_size, h), min(max_size, h) + 1)
    left = rng.randint(0, w - cw + 1)
    top = rng.randint(0, h - ch + 1)
    out = image[top : top + ch, left : left + cw]
    if not len(boxes):
        return out, boxes, labels
    shifted = boxes - np.array([left, top, left, top], np.float32)
    clipped = shifted.copy()
    clipped[:, [0, 2]] = clipped[:, [0, 2]].clip(0, cw)
    clipped[:, [1, 3]] = clipped[:, [1, 3]].clip(0, ch)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    clipped_area = (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])
    keep = clipped_area >= keep_overlap * np.maximum(area, 1e-6)
    return out, clipped[keep], labels[keep]


def center_crop(image: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                ch: int, cw: int):
    """Deterministic center crop (new_datasets/transforms.py CenterCrop)."""
    h, w = image.shape[:2]
    top = max((h - ch) // 2, 0)
    left = max((w - cw) // 2, 0)
    out = image[top : top + ch, left : left + cw]
    if not len(boxes):
        return out, boxes, labels
    shifted = boxes - np.array([left, top, left, top], np.float32)
    shifted[:, [0, 2]] = shifted[:, [0, 2]].clip(0, out.shape[1])
    shifted[:, [1, 3]] = shifted[:, [1, 3]].clip(0, out.shape[0])
    keep = (shifted[:, 2] > shifted[:, 0]) & (shifted[:, 3] > shifted[:, 1])
    return out, shifted[keep], labels[keep]


def random_pad(image: np.ndarray, boxes: np.ndarray,
               rng: np.random.RandomState, max_pad: int):
    """Pad right/bottom by a random amount (new transforms RandomPad)."""
    pr, pb = rng.randint(0, max_pad + 1, size=2)
    out = np.pad(image, ((0, pb), (0, pr), (0, 0)))
    return out, boxes


def random_erasing(image: np.ndarray, rng: np.random.RandomState,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3), p: float = 0.5):
    """Random rectangle erasure (new transforms RandomErasing)."""
    if rng.rand() >= p:
        return image
    h, w = image.shape[:2]
    area = h * w * rng.uniform(*scale)
    aspect = rng.uniform(*ratio)
    eh = int(round(np.sqrt(area * aspect)))
    ew = int(round(np.sqrt(area / aspect)))
    if eh >= h or ew >= w or eh < 1 or ew < 1:
        return image
    top = rng.randint(0, h - eh)
    left = rng.randint(0, w - ew)
    out = image.copy()
    out[top : top + eh, left : left + ew] = rng.randint(
        0, 256, (eh, ew, image.shape[2]), dtype=np.uint8
    )
    return out


class RandomSelect:
    """Apply transform A with probability p, else B
    (datasets/transforms_.py RandomSelect)."""

    def __init__(self, transform_a, transform_b, p: float = 0.5):
        self.a, self.b, self.p = transform_a, transform_b, p

    def __call__(self, image, boxes, labels, rng):
        t = self.a if rng.rand() < self.p else self.b
        return t(image, boxes, labels, rng)


def normalize(image: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 ImageNet-normalised."""
    return (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class TrainAugment:
    """The active reference train pipeline: HFlip(0.5) + Resize(800, 1333)
    (datasets/build.py:10-24), with optional extras for the "plus"
    recipes (photometric / zoom-out / crop)."""

    def __init__(
        self,
        size: int | tuple[int, ...] = 800,
        max_size: int = 1333,
        hflip_prob: float = 0.5,
        photometric: bool = False,
        zoom_out_prob: float = 0.0,
        crop_prob: float = 0.0,
    ):
        # A tuple of sizes gives DETR-style multi-scale RandomResize; all
        # results must fit the loader's static canvas, so the largest size
        # defines the canvas bucket.
        self.sizes = (size,) if isinstance(size, int) else tuple(size)
        self.size = max(self.sizes)
        self.max_size = max_size
        self.hflip_prob = hflip_prob
        self.photometric = photometric
        self.zoom_out_prob = zoom_out_prob
        self.crop_prob = crop_prob

    def __call__(self, image, boxes, labels, rng: np.random.RandomState):
        if self.photometric:
            image = photometric_distort(image, rng)
        if self.zoom_out_prob and rng.rand() < self.zoom_out_prob:
            image, boxes = zoom_out(image, boxes, rng)
        if self.crop_prob and rng.rand() < self.crop_prob and len(boxes):
            image, boxes, labels = random_crop(
                image, boxes, labels, rng, 384, min(image.shape[:2])
            )
        if rng.rand() < self.hflip_prob:
            image, boxes = hflip(image, boxes)
        size = self.sizes[rng.randint(len(self.sizes))]
        image, boxes = resize_min_side(image, boxes, size, self.max_size)
        return image, boxes, labels


class EvalTransform:
    """Resize-only test pipeline (batch-1 loader, datasets/build.py)."""

    def __init__(self, size: int = 800, max_size: int = 1333):
        self.size = size
        self.max_size = max_size

    def __call__(self, image, boxes, labels, rng=None):
        image, boxes = resize_min_side(image, boxes, self.size, self.max_size)
        return image, boxes, labels

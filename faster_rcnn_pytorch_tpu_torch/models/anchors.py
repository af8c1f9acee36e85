"""Legacy (VGG16) anchors, in numpy.

A copy of ``legacy_anchor_base`` / ``legacy_anchors`` from
``faster_rcnn_pytorch_tpu/models/anchors.py``, so the port needs nothing
of the JAX package: base size 16, scales {8, 16, 32}, ratios
{0.5, 1, 2} (``w = 16*s*sqrt(r)``, ``h = 16*s*sqrt(1/r)``), centers at
8 px, stride 16, ordered (y, x, ratio-major / scale-minor) and
normalised to [0, 1] by the canvas.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def legacy_anchor_base(
    base_size: int = 16,
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
    scales: tuple[int, ...] = (8, 16, 32),
) -> np.ndarray:
    """9 base anchors in xyxy pixels centered at (base/2, base/2)."""
    px = py = base_size / 2.0
    out = np.zeros((len(ratios) * len(scales), 4), dtype=np.float32)
    for i, r in enumerate(ratios):
        for j, s in enumerate(scales):
            w = base_size * s * np.sqrt(r)
            h = base_size * s * np.sqrt(1.0 / r)
            out[i * len(scales) + j] = (
                px - w / 2.0,
                py - h / 2.0,
                px + w / 2.0,
                py + h / 2.0,
            )
    return out


@functools.lru_cache(maxsize=64)
def legacy_anchors(
    height: int,
    width: int,
    base_size: int = 16,
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
    scales: tuple[int, ...] = (8, 16, 32),
) -> np.ndarray:
    """All anchors of a ``height x width`` canvas, ``[(H//16)*(W//16)*9, 4]``
    float32 xyxy in [0, 1]."""
    base = legacy_anchor_base(base_size, ratios, scales)
    fh, fw = height // base_size, width // base_size
    shift_x = np.arange(fw, dtype=np.float32) * base_size
    shift_y = np.arange(fh, dtype=np.float32) * base_size
    sx, sy = np.meshgrid(shift_x, shift_y)
    shift = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    anchors = (base[None, :, :] + shift[:, None, :]).reshape(-1, 4)
    anchors /= np.array([width, height, width, height], dtype=np.float32)
    return anchors.astype(np.float32)

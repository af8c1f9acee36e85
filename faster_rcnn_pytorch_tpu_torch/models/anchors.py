"""Anchors of both generations, in numpy.

A copy of ``legacy_anchor_base`` / ``legacy_anchors`` / ``fpn_cell_anchors``
/ ``fpn_anchors`` / ``num_fpn_anchors`` / ``inside_fraction`` from
``faster_rcnn_pytorch_tpu/models/anchors.py``, so the port needs nothing
of the JAX package.

* Legacy: base size 16, scales {8, 16, 32}, ratios {0.5, 1, 2}
  (``w = 16*s*sqrt(r)``, ``h = 16*s*sqrt(1/r)``), centers at 8 px,
  stride 16, ordered (y, x, ratio-major / scale-minor).
* FPN: one size per level (32..512 px at strides 4..64), three ratios,
  torchvision's rounded cell anchors centred on the cell origin; level
  grids are ``ceil(H / stride)``, ordered (level, y, x, anchor).

Both are normalised to [0, 1] by the canvas.
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


@functools.lru_cache(maxsize=64)
def fpn_cell_anchors(size: int, ratios: tuple[float, ...] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """torchvision-style rounded base anchors ``[A, 4]`` for one FPN level."""
    r = np.asarray(ratios, dtype=np.float32)
    h_ratios = np.sqrt(r)
    w_ratios = 1.0 / h_ratios
    ws = w_ratios * size
    hs = h_ratios * size
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base).astype(np.float32)


@functools.lru_cache(maxsize=64)
def fpn_anchors(
    height: int,
    width: int,
    strides: tuple[int, ...] = (4, 8, 16, 32, 64),
    sizes: tuple[int, ...] = (32, 64, 128, 256, 512),
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """All-level FPN anchors of a ``height x width`` canvas,
    ``[num_fpn_anchors, 4]`` float32 xyxy in [0, 1]."""
    per_level = []
    for stride, size in zip(strides, sizes):
        fh = -(-height // stride)
        fw = -(-width // stride)
        base = fpn_cell_anchors(size, ratios)
        sx = np.arange(fw, dtype=np.float32) * stride
        sy = np.arange(fh, dtype=np.float32) * stride
        gx, gy = np.meshgrid(sx, sy)
        shift = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], 1)
        per_level.append((shift[:, None, :] + base[None, :, :]).reshape(-1, 4))
    anchors = np.concatenate(per_level, axis=0)
    anchors /= np.array([width, height, width, height], dtype=np.float32)
    return anchors.astype(np.float32)


def num_fpn_anchors(height: int, width: int, strides: tuple[int, ...] = (4, 8, 16, 32, 64)) -> int:
    return sum(3 * -(-height // s) * -(-width // s) for s in strides)


def inside_fraction(anchors: np.ndarray, extent: tuple[float, float]) -> float:
    """Fraction of ``anchors`` lying fully inside an ``(ex, ey)`` extent:
    the eligibility test of the RPN boundary filter (``rpn_targets``).
    The train CLI warns when small canvases leave almost none."""
    ex, ey = float(extent[0]), float(extent[1])
    inside = (
        (anchors[:, 0] >= 0.0)
        & (anchors[:, 1] >= 0.0)
        & (anchors[:, 2] <= ex)
        & (anchors[:, 3] <= ey)
    )
    return float(inside.mean()) if len(anchors) else 0.0

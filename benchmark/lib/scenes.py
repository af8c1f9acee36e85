"""Scene pools from ``--seed``: the one generator every traffic file feeds.

A pool holds ``POOL`` distinct host batches of ``batch`` images on the
padded canvas (the loader's layout: NHWC float32 with zeros past each
image's extent, ``extent`` as (w, h) fractions, gt padded to ``max_gt``
slots). Every seed gets the same extents and the same multiset of box
counts (the traffic file's ``box_counts``), in another order, so a seed
changes the content and not the amount of work. The pixels are drawn on
the device, a batch a call, and copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

BATCH_KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")
POOL = 16  # distinct host batches a run cycles through
TILE_FROM = 5  # an image with this many boxes or more has them tiled


def extents(batch: int, canvas) -> np.ndarray:
    """(w, h) fractions of each batch position: full or 3/4 height, 0.9,
    0.8 or 0.7 of the width."""
    ch, cw = canvas
    out = np.zeros((batch, 2), np.float32)
    for i in range(batch):
        rh = ch if i % 2 == 0 else int(ch * 0.75)
        rw = int(cw * (0.9 - 0.1 * (i % 3)))
        out[i] = (rw / cw, rh / ch)
    return out


def box_counts(spec: dict, n: int) -> np.ndarray:
    """The pool's ``n`` box counts, in a fixed order: ``histogram`` lists
    ``[count, images]`` pairs that sum to ``n``; ``linspace`` ``[lo, hi]``
    spaces ``n`` counts evenly."""
    if "histogram" in spec:
        counts = np.concatenate([np.full(k, c) for c, k in spec["histogram"]])
        if counts.size != n:
            raise ValueError(f"box_counts histogram holds {counts.size} images, the pool {n}")
        return counts.astype(np.int64)
    lo, hi = spec["linspace"]
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def _boxes(rs, k: int, ext):
    """``k`` boxes inside ``ext``: a few large ones anywhere, or (from
    ``TILE_FROM`` on) small ones tiled over the extent, one a grid cell."""
    if k < TILE_FROM:
        xy = rs.uniform(0.05, 0.5, size=(k, 2)) * ext
        wh = rs.uniform(0.15, 0.45, size=(k, 2)) * ext
    else:
        cols = int(np.ceil(np.sqrt(k * ext[0] / ext[1])))
        rows = -(-k // cols)
        cell = ext / (cols, rows)
        slots = np.sort(rs.choice(cols * rows, size=k, replace=False))
        xy = np.stack([slots % cols, slots // cols], 1) * cell + rs.uniform(0.05, 0.25, size=(k, 2)) * cell
        wh = rs.uniform(0.5, 0.7, size=(k, 2)) * cell
    return np.concatenate([xy, np.minimum(xy + wh, ext)], 1)


def pool(traffic: dict, canvas, seed: int, device, with_boxes: bool = True) -> list[dict]:
    """``POOL`` host batches (numpy) on the ``(H, W)`` canvas from ``seed``."""
    n_batches, batch = POOL, int(traffic["batch"])
    canvas = tuple(canvas)
    ch, cw = canvas
    ext = extents(batch, canvas)
    gen = torch.Generator(device=device).manual_seed(seed)
    inside = torch.stack([
        (torch.arange(ch, device=device)[:, None] < round(e[1] * ch))
        & (torch.arange(cw, device=device)[None, :] < round(e[0] * cw))
        for e in ext
    ])[..., None]  # [B, H, W, 1]
    images = []
    for _ in range(n_batches):
        pixels = torch.randn((batch, ch, cw, 3), generator=gen, device=device)
        images.append((pixels * inside).cpu().numpy())
    del pixels
    rs = np.random.default_rng(seed)
    counts = None
    if with_boxes:
        counts = rs.permutation(box_counts(traffic["box_counts"], n_batches * batch))
        if counts.max() > int(traffic["max_gt"]):
            raise ValueError(f"{counts.max()} boxes exceed max_gt {traffic['max_gt']}")
    out = []
    for j in range(n_batches):
        b = {"image": images[j], "extent": ext.copy()}
        if with_boxes:
            g = int(traffic["max_gt"])
            gt_boxes = np.zeros((batch, g, 4), np.float32)
            gt_labels = np.zeros((batch, g), np.int32)
            gt_mask = np.zeros((batch, g), bool)
            first, last = traffic["labels"]
            for i in range(batch):
                k = int(counts[j * batch + i])
                gt_boxes[i, :k] = _boxes(rs, k, ext[i])
                gt_labels[i, :k] = rs.integers(first, last + 1, size=k)
                gt_mask[i, :k] = True
            b.update(gt_boxes=gt_boxes, gt_labels=gt_labels, gt_mask=gt_mask)
        out.append(b)
    return out


def to_device(host: dict, device) -> dict:
    """A host batch on the device, copied as the train loop copies it."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}

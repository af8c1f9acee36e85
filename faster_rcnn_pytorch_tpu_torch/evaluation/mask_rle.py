"""COCO run-length mask encoding (pycocotools ``maskApi`` format).

The port's own copy of ``faster_rcnn_pytorch_tpu/evaluation/mask_rle.py``
(numpy only): the strings are the JAX package's, character for character.

The reference's evaluator carries segmentation/keypoint result-prepare
paths (evaluation/coco_eval.py:94-153) that lean on pycocotools'
``mask_util.encode``. pycocotools is not a dependency of this framework
(the evaluator is a from-scratch numpy implementation), so the RLE codec
is implemented here: column-major run lengths starting with a background
run, compressed to the maskApi varint string — 5-bit little-endian
chunks offset by 48 (``'0'``), continuation bit 0x20, sign-extension on
a final chunk with bit 0x10 set, and counts delta-encoded against
``cnts[i-2]`` from the fourth count on (the ``if (i > 2)`` quirk in
maskApi.c's rleToString/rleFrString).

Both compressed strings and uncompressed integer lists are valid COCO
result ``segmentation`` payloads; :func:`encode` emits the compressed
form like the reference.
"""

from __future__ import annotations

import numpy as np


def mask_to_counts(mask: np.ndarray) -> list[int]:
    """Binary ``[h, w]`` mask -> column-major run lengths (uncompressed
    RLE ``counts``), first run counting zeros."""
    flat = np.asarray(mask, bool).flatten(order="F").astype(np.int8)
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0]
    runs = np.diff(np.concatenate([[-1], change, [flat.size - 1]]))
    counts = runs.tolist()
    if flat[0] == 1:  # counts must start with a zero-run
        counts = [0] + counts
    return [int(c) for c in counts]


def counts_to_mask(counts: list[int], shape: tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`mask_to_counts`."""
    h, w = shape
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = not val
    return flat.reshape((h, w), order="F")


def counts_to_string(counts: list[int]) -> str:
    """Compress run lengths to the maskApi varint string."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def string_to_counts(s: str) -> list[int]:
    """Inverse of :func:`counts_to_string`."""
    counts: list[int] = []
    p = 0
    while p < len(s):
        x, k = 0, 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> dict:
    """Binary ``[h, w]`` mask -> COCO compressed RLE dict
    (``{"size": [h, w], "counts": str}``), the reference's
    ``mask_util.encode`` + utf-8 decode (coco_eval.py:109-114)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(mask_to_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    """COCO RLE dict (compressed string or uncompressed list counts) ->
    binary ``[h, w]`` mask."""
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        if isinstance(counts, bytes):
            counts = counts.decode("utf-8")
        counts = string_to_counts(counts)
    return counts_to_mask(list(counts), tuple(rle["size"]))


def iou(rle_a: dict, rle_b: dict, iscrowd: bool = False) -> float:
    """Mask IoU (maskApi rleIou semantics: crowd gt -> intersection over
    det area)."""
    a, b = decode(rle_a), decode(rle_b)
    inter = float(np.logical_and(a, b).sum())
    if iscrowd:
        area = float(a.sum())
    else:
        area = float(a.sum() + b.sum()) - inter
    return inter / area if area > 0 else 0.0

"""Serving helpers. Only :func:`pack_detections` is ported so far."""

from __future__ import annotations

import torch


def pack_detections(det) -> torch.Tensor:
    """``Detections -> [B, D, 7]`` float32 (x1, y1, x2, y2, label, score,
    valid): one buffer to copy to the host per batch."""
    return torch.cat(
        [
            det.boxes.float(),
            det.labels[..., None].float(),
            det.scores[..., None].float(),
            det.valid[..., None].float(),
        ],
        dim=-1,
    )

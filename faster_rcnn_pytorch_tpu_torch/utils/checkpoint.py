"""Train-state checkpoints: save, resume and retention, torch-native.

Counterpart of the save/load/naming/pruning half of
``faster_rcnn_pytorch_tpu/utils/checkpoint.py``. A checkpoint is one
``torch.save`` file ``{"model", "optimizer", "step", "metadata"}``,
written atomically (tmp file, then ``os.replace``), at
``{log_dir}/{name}/saves/{name}.{epoch}.pt`` plus a ``best`` copy. The
suffix is ``.pt``, not the JAX package's ``.ckpt``, so a flax checkpoint
is never read as a torch one. Reference-layout ``.pth``/``.pth.tar``
weights are read by ``utils/convert.load_reference_checkpoint``.
"""

from __future__ import annotations

import os
import re

import torch

SUFFIX = ".pt"


def checkpoint_path(log_dir: str, name: str, epoch: int | str) -> str:
    return os.path.join(log_dir, name, "saves", f"{name}.{epoch}{SUFFIX}")


def save_checkpoint(path: str, state, metadata: dict | None = None) -> None:
    """Write ``state`` (a ``parallel.train_step.TrainState``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "metadata": metadata or {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state):
    """Restore ``state`` in place from ``path``; returns ``(state,
    metadata)``. Tensors land on the model's device."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, payload["metadata"]


def prune_checkpoints(log_dir: str, name: str, keep_last: int) -> list[str]:
    """Delete all but the newest ``keep_last`` per-epoch checkpoints (0
    keeps all). The ``best`` copy is never deleted. Returns the removed
    paths."""
    if keep_last <= 0:
        return []
    saves = os.path.dirname(checkpoint_path(log_dir, name, 0))
    if not os.path.isdir(saves):
        return []
    pat = re.compile(re.escape(name) + r"\.(\d+)" + re.escape(SUFFIX))
    epochs = sorted(int(m.group(1)) for f in os.listdir(saves) if (m := pat.fullmatch(f)))
    removed = []
    for e in epochs[: max(len(epochs) - keep_last, 0)]:
        path = checkpoint_path(log_dir, name, e)
        os.remove(path)
        removed.append(path)
    return removed

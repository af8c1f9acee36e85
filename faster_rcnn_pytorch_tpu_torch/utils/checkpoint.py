"""Train-state checkpoints: save, resume and retention, torch-native.

Counterpart of the save/load/naming/pruning half of
``faster_rcnn_pytorch_tpu/utils/checkpoint.py``. A checkpoint is one
``torch.save`` file ``{"model", "optimizer", "step", "metadata"}``,
written atomically (tmp file, then ``os.replace``), at
``{log_dir}/{name}/saves/{name}.{epoch}.pt`` plus a ``best`` copy. The
suffix is ``.pt``, not the JAX package's ``.ckpt``, so a flax checkpoint
is never read as a torch one. Reference-layout ``.pth``/``.pth.tar``
weights are read by ``utils/convert.load_reference_checkpoint``.
:func:`resolve_and_load_params` is the eval CLI's checkpoint policy (the
JAX package's function of that name).
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


def resolve_and_load_params(opts, model: torch.nn.Module) -> str:
    """Load the weights ``opts.checkpoint`` names into ``model`` (the
    counterpart of the JAX package's ``resolve_and_load_params``, one
    policy for the eval CLIs). Returns a note for the console.

    * ``*.pth`` / ``*.pth.tar``: reference-layout weights, imported by
      ``utils/convert.load_reference_checkpoint``.
    * ``*.pt``: a port train checkpoint, which must exist; only its
      ``model`` entry is loaded (``strict=True``).
    * empty: the run's ``{log_dir}/{name}/saves/{name}.{test_epoch}.pt``.
      If it is missing, the model gets the fresh init seeded by
      ``opts.seed`` and the note names the missing path.
    * anything else: ``ValueError``. Going on with random weights after a
      typo in the path is the worst failure an eval CLI can have.
    """
    ckpt = opts.checkpoint
    if ckpt.endswith((".pth.tar", ".pth")):
        from faster_rcnn_pytorch_tpu_torch.utils.convert import load_reference_checkpoint

        model.load_state_dict(load_reference_checkpoint(ckpt), strict=True)
        return f"imported torch checkpoint {ckpt}"
    if ckpt and not ckpt.endswith(SUFFIX):
        raise ValueError(
            f"--checkpoint {ckpt!r}: expected a port {SUFFIX} checkpoint or "
            "reference .pth/.pth.tar weights"
        )
    path = ckpt or checkpoint_path(opts.log_dir, opts.name, opts.test_epoch)
    if not os.path.isfile(path):
        if ckpt:  # an explicit path must exist
            raise FileNotFoundError(f"--checkpoint {ckpt!r}: no such file")
        from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import init_weights

        init_weights(model, torch.Generator().manual_seed(opts.seed))
        return f"no checkpoint at {path}; fresh init with seed {opts.seed}"
    # mmap: the optimizer state beside the weights is never read.
    payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    model.load_state_dict(payload["model"], strict=True)
    return f"loaded {path} (epoch {payload['metadata'].get('epoch')})"


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


def load_detector(opts):
    """The demo and export CLIs' detector: ``opts.num_classes`` set by data
    type (VOC 21; COCO 81 legacy, 91 FPN), the model built with the
    dataset's label offset, and its weights as
    :func:`resolve_and_load_params` resolves them. Returns ``(model, cfg,
    note)``, the model float32 on the CPU."""
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, label_offset_for

    if opts.data_type == "voc":
        opts.num_classes = 21
    elif opts.model_generation == "legacy":
        opts.num_classes = 81
    else:
        opts.num_classes = 91
    model, cfg = build_model(
        opts.model_generation,
        opts.num_classes,
        label_offset=label_offset_for(opts.model_generation, opts.data_type),
    )
    note = resolve_and_load_params(opts, model)
    return model, cfg, note


def save_torch_checkpoint(path: str, model: torch.nn.Module, epoch: int = 0) -> None:
    """Write the reference-format ``.pth.tar`` blob ``{"epoch",
    "model_state_dict"}`` (the JAX package's ``save_torch_checkpoint``):
    the model's state dict is already in the reference layout, so the
    reference's resume path loads it. Float32 CPU tensors, atomic write."""
    blob = {
        "epoch": epoch,
        "model_state_dict": {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)

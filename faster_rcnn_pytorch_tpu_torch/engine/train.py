"""Train loop (counterpart of ``faster_rcnn_pytorch_tpu/engine/train.py``).

Per step: copy the host batch to the model's device and run the train
step (forward, four-part loss, backward, SGD update); every ``vis_step``
steps read the metrics back and log them to the console and the scalar
writer. After the epoch: save its checkpoint, then prune old ones.

Under data parallelism every rank runs this loop over its rows of each
batch with the same epoch generator (the step slices the global batch's
noise); the metrics it reads are the global batch's, and only global
rank 0 prints and writes scalars (``utils/logging.py``). Every rank calls
the checkpoint save, which gathers the tensor-parallel shards; rank 0
writes the single-device layout (``utils/checkpoint.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    prune_checkpoints,
    save_checkpoint,
)
from faster_rcnn_pytorch_tpu_torch.utils.logging import MetricLogger, ScalarWriter, print0

BATCH_KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The sampling-noise generator of one epoch, on ``device``, seeded
    like the JAX package's per-epoch key (``seed * 100_003 + epoch``)."""
    return torch.Generator(device=device).manual_seed(seed * 100_003 + epoch)


def train_one_epoch(
    state,
    step_fn,
    loader,
    epoch: int,
    opts,
    schedule,
    writer: ScalarWriter | None = None,
):
    """Run one epoch of ``step_fn`` (``parallel.train_step``) over
    ``loader.epoch(epoch)``; returns ``state``, updated in place."""
    device = next(state.model.parameters()).device
    logger = MetricLogger()
    generator = epoch_generator(opts.seed, epoch, device)
    steps_per_epoch = len(loader)

    for i, host_batch in logger.log_every(
        loader.epoch(epoch), opts.vis_step, header=f"epoch {epoch}"
    ):
        batch = {
            k: torch.from_numpy(np.ascontiguousarray(host_batch[k])).to(device)
            for k in BATCH_KEYS
        }
        metrics = step_fn(state, batch, generator)
        if i % opts.vis_step == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            step = epoch * steps_per_epoch + i
            lr = schedule(step)
            logger.update(
                lr=lr, **{k: metrics[k] for k in ("loss", "rpn_cls", "rpn_reg", "roi_cls", "roi_reg")}
            )
            if writer is not None:
                for k, v in metrics.items():
                    writer.scalar(f"train/{k}", v, step)
                writer.scalar("train/lr", lr, step)

    path = checkpoint_path(opts.log_dir, opts.name, epoch)
    save_checkpoint(
        path,
        state,
        metadata={"epoch": epoch},
        backend=getattr(opts, "ckpt_backend", "flax"),
        async_save=getattr(opts, "async_checkpoint", False),
    )
    print0(f"saved checkpoint {path}", flush=True)
    prune_checkpoints(opts.log_dir, opts.name, opts.keep_checkpoints)
    return state

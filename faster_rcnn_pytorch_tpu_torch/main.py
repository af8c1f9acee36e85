"""Train CLI of the port (counterpart of ``faster_rcnn_pytorch_tpu/main.py``).

``python -m faster_rcnn_pytorch_tpu_torch.main --data_root ./data``

One device (``utils.runtime.select_device``), either generation
(``--model_generation legacy|fpn``) on VOC or COCO (``--data_type``).
Orchestration: options -> loaders -> model (with the dataset's label
offset) -> weights (seeded fresh init, or a reference-layout
``.pth``/``.pth.tar`` of either generation) -> LR schedule -> optimizer ->
resume (from ``{log_dir}/{name}/saves/{name}.{start_epoch - 1}.pt``, or
from ``--checkpoint x.pt``, model and optimizer; either must exist) ->
epochs of train, evaluate (VOC, or COCO against
``annotations/instances_val2017.json`` under the data root) and
best-by-mAP checkpoint, which ``test --test_epoch best`` then loads.

``--dtype bfloat16`` runs forward and backward under
``torch.autocast(bfloat16)`` over float32 master weights (the JAX
package's ``dtype=bf16, param_dtype=float32``); the losses stay float32.
``--dtype float32`` means TF32 off unless ``--matmul_precision high``
turns it on (``utils.runtime.apply_matmul_precision``). Flags of slices
not ported yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

# What this slice refuses, and where each lands (ROADMAP.md Queue A).
_NOT_PORTED = (
    (lambda o: o.model_parallel > 1, "--model_parallel > 1", "item 14"),
    (lambda o: o.num_hosts > 1, "--num_hosts > 1", "item 14"),
    (lambda o: bool(o.coordinator), "--coordinator", "item 14"),
    (lambda o: o.num_devices > 1, "--num_devices > 1", "item 14"),
    (lambda o: o.remat_backbone, "--remat_backbone", "item 14"),
    (lambda o: bool(o.pretrained_backbone), "--pretrained_backbone", "item 15"),
    (lambda o: o.checkpoint == "pretrained", "--checkpoint pretrained", "item 15"),
    (lambda o: o.ckpt_backend == "orbax", "--ckpt_backend orbax", "item 14"),
    (lambda o: o.async_checkpoint, "--async_checkpoint", "item 14"),
)


def refuse_unported(opts) -> None:
    for test, flag, item in _NOT_PORTED:
        if test(opts):
            raise NotImplementedError(
                f"{flag} is not ported to PyTorch yet; see ROADMAP.md Queue A {item}"
            )


def _preflight(model, train_loader, opts) -> None:
    """Warn when the legacy boundary filter leaves under 1% of the anchors
    trainable (small canvases; the RPN then cannot learn)."""
    from faster_rcnn_pytorch_tpu_torch.models.anchors import inside_fraction

    for ch, cw in {train_loader.canvas_land, train_loader.canvas_port}:
        ext = (min(opts.resize / cw, 1.0), min(opts.resize / ch, 1.0))
        frac = inside_fraction(model.canvas_anchors(ch, cw), ext)
        if frac < 0.01:
            print(
                f"WARNING: only {frac:.2%} of RPN anchors fit inside a square "
                f"image's extent on the {ch}x{cw} canvas; the boundary filter "
                "will leave the RPN nearly untrainable. The legacy anchors are "
                "128-512px: raise --resize to >=320.",
                flush=True,
            )


def main(argv=None) -> int:
    from faster_rcnn_pytorch_tpu_torch.config import load_options
    from faster_rcnn_pytorch_tpu_torch.data.loader import build_dataloader
    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate, label_map_for
    from faster_rcnn_pytorch_tpu_torch.engine.train import train_one_epoch
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (
        build_model,
        init_weights,
        label_offset_for,
    )
    from faster_rcnn_pytorch_tpu_torch.parallel.train_step import (
        init_train_state,
        make_lr_schedule,
        make_optimizer,
        make_train_step,
    )
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        load_checkpoint,
        save_checkpoint,
    )
    from faster_rcnn_pytorch_tpu_torch.utils.convert import load_reference_checkpoint
    from faster_rcnn_pytorch_tpu_torch.utils.logging import ScalarWriter, trace_context
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        select_device,
        set_numerics,
    )

    opts = load_options(argv)
    refuse_unported(opts)
    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    device = select_device()
    autocast_dtype = dtype if dtype != torch.float32 else None

    train_loader, test_loader = build_dataloader(opts)
    model, cfg = build_model(
        opts.model_generation,
        opts.num_classes,
        label_offset=label_offset_for(opts.model_generation, opts.data_type),
    )
    if cfg.rpn_boundary_filter:
        _preflight(model, train_loader, opts)

    coco_index = None
    if opts.data_type == "coco":
        from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex

        coco_index = CocoIndex(
            os.path.join(opts.data_root, "annotations", "instances_val2017.json")
        )
    label_map = label_map_for(opts, coco_index)

    if opts.checkpoint.endswith((".pth.tar", ".pth")):
        model.load_state_dict(load_reference_checkpoint(opts.checkpoint), strict=True)
        print(f"imported torch checkpoint {opts.checkpoint}", flush=True)
    elif opts.checkpoint and not opts.checkpoint.endswith(".pt"):
        raise ValueError(
            f"--checkpoint {opts.checkpoint!r}: the port reads .pth/.pth.tar "
            "weights or its own .pt train checkpoints"
        )
    else:
        init_weights(model, torch.Generator().manual_seed(opts.seed))
    model = model.to(device)

    steps_per_epoch = max(len(train_loader), 1)
    schedule = make_lr_schedule(
        opts.scheduler,
        opts.lr,
        opts.epoch,
        steps_per_epoch,
        milestones=tuple(opts.milestones),
        eta_min=opts.eta_min,
        warmup_epochs=opts.warmup_epoch,
        cycle_mult=opts.cycle_mult,
        restart_gamma=opts.cycle_gamma,
        first_cycle_epochs=opts.first_cycle_epoch,
    )
    optimizer = make_optimizer(model, momentum=opts.momentum, weight_decay=opts.weight_decay)
    state = init_train_state(model, optimizer)

    if opts.start_epoch > 0:
        path = checkpoint_path(opts.log_dir, opts.name, opts.start_epoch - 1)
        state, meta = load_checkpoint(path, state)
        print(f"resumed from {path} (epoch {meta.get('epoch')})", flush=True)
    elif opts.checkpoint.endswith(".pt"):
        state, _ = load_checkpoint(opts.checkpoint, state)
        print(f"loaded checkpoint {opts.checkpoint}", flush=True)

    accum = max(opts.grad_accum, 1)
    if train_loader.batch_size % accum:
        raise SystemExit(
            f"--grad_accum {accum} must divide the batch size {train_loader.batch_size}"
        )
    step_fn = make_train_step(cfg, schedule, grad_accum=accum, autocast_dtype=autocast_dtype)
    writer = ScalarWriter(opts.log_dir, opts.name, opts.log_backend)
    eval_autocast = (
        torch.autocast(device.type, dtype=autocast_dtype)
        if autocast_dtype is not None
        else contextlib.nullcontext()
    )

    best_map = -1.0
    for epoch in range(opts.start_epoch, opts.epoch):
        with trace_context(
            f"{opts.log_dir}/{opts.name}/trace",
            enabled=opts.profile and epoch == opts.start_epoch,
        ):
            state = train_one_epoch(
                state, step_fn, train_loader, epoch, opts, schedule, writer
            )
        with eval_autocast:
            result = evaluate(
                model,
                cfg,
                test_loader,
                data_type=opts.data_type,
                coco_index=coco_index,
                label_map=label_map,
                score_threshold=opts.thres,
            )
        writer.scalar("eval/mAP", result["map"], epoch)
        print(f"epoch {epoch}: mAP = {result['map']:.4f}", flush=True)
        if result["map"] > best_map:
            best_map = result["map"]
            save_checkpoint(
                checkpoint_path(opts.log_dir, opts.name, "best"),
                state,
                metadata={"epoch": epoch, "map": best_map},
            )
    writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

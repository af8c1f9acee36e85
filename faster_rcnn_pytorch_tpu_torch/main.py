"""Train CLI of the port (counterpart of ``faster_rcnn_pytorch_tpu/main.py``).

``python -m faster_rcnn_pytorch_tpu_torch.main --data_root ./data``

Either generation, or Cascade R-CNN R50-FPN (``--model_generation
legacy|fpn|cascade``), on VOC or COCO (``--data_type``). Orchestration: options -> processes -> loaders ->
model (with the dataset's label offset) -> weights (``utils.checkpoint.
init_params``: a seeded fresh init, its backbone from ``--pretrained_backbone``
if given, or a reference-layout ``.pth``/``.pth.tar`` of either
generation, ``--checkpoint pretrained`` the released demo detector) -> tensor
parallelism -> LR schedule -> optimizer -> resume (from
``{log_dir}/{name}/saves/{name}.{start_epoch - 1}.pt``, or from
``--checkpoint x.pt``, model and optimizer; either must exist) -> epochs
of train, evaluate (VOC, or COCO against
``annotations/instances_val2017.json`` under the data root) and
best-by-mAP checkpoint, which ``test --test_epoch best`` then loads.

Scale (the JAX package's mesh flags, ``parallel/mesh.py``): one process
per card, started by ``torch.multiprocessing.spawn``. The count on a host
is the largest ``k <= --num_devices`` (0: every card) with ``k %
--model_parallel == 0`` and the per-host batch divisible by ``k /
--model_parallel``, as JAX sizes its mesh. ``--num_hosts``,
``--host_id`` and ``--coordinator host:port`` join the hosts' processes
into one group. Gradients go over DDP (NCCL on cards, gloo on the CPU);
``--model_parallel`` splits fc6/fc7 Megatron-style;
``--remat_backbone`` recomputes the backbone's activations in the
backward; ``--ckpt_backend orbax`` writes directory checkpoints,
``--async_checkpoint`` without waiting for them.

``--dtype bfloat16`` runs forward and backward under
``torch.autocast(bfloat16)`` over float32 master weights (the JAX
package's ``dtype=bf16, param_dtype=float32``); the losses stay float32;
each epoch's eval casts a bfloat16 copy of the weights, as ``test`` and
the JAX ``evaluate`` do. ``--dtype float32`` means TF32 off unless
``--matmul_precision high`` turns it on
(``utils.runtime.apply_matmul_precision``).

The weight flags are resolved to files in the parent, before it starts a
process a card (``utils.checkpoint.resolve_weight_specs``): one process a
host fetches, from the cache ``FRT_CACHE_DIR`` or the network, and the
ranks read the files it names.
"""

from __future__ import annotations

import os
import socket
import sys

import torch


def _preflight(model, train_loader, opts) -> None:
    """Warn when the legacy boundary filter leaves under 1% of the anchors
    trainable (small canvases; the RPN then cannot learn)."""
    from faster_rcnn_pytorch_tpu_torch.models.anchors import inside_fraction
    from faster_rcnn_pytorch_tpu_torch.utils.logging import print0

    for ch, cw in {train_loader.canvas_land, train_loader.canvas_port}:
        ext = (min(opts.resize / cw, 1.0), min(opts.resize / ch, 1.0))
        frac = inside_fraction(model.canvas_anchors(ch, cw), ext)
        if frac < 0.01:
            print0(
                f"WARNING: only {frac:.2%} of RPN anchors fit inside a square "
                f"image's extent on the {ch}x{cw} canvas; the boundary filter "
                "will leave the RPN nearly untrainable. The legacy anchors are "
                "128-512px: raise --resize to >=320.",
                flush=True,
            )


def device_plan(opts, avail: int) -> int:
    """Processes on this host: the largest ``k <= avail`` with ``k %
    model_parallel == 0`` and the per-host batch divisible by ``k /
    model_parallel`` (the JAX ``main``'s mesh size)."""
    mp = max(opts.model_parallel, 1)
    per_host_batch = max(opts.batch_size // opts.num_hosts, 1)
    return max(
        (k for k in range(1, avail + 1) if k % mp == 0 and per_host_batch % (k // mp) == 0),
        default=mp,
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    from faster_rcnn_pytorch_tpu_torch.config import load_options
    from faster_rcnn_pytorch_tpu_torch.parallel.mesh import device_count
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import resolve_weight_specs
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        select_device,
        set_numerics,
    )

    opts = load_options(argv)
    set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    device_type = select_device().type
    avail = device_count(opts.num_devices, device_type)
    n_dev = device_plan(opts, avail)
    # Downloads happen here, once a host; every rank then reads the files.
    resolve_weight_specs(opts)
    if n_dev == 1 and opts.num_hosts == 1 and not opts.coordinator:
        return train(opts, 0, 1, avail)
    if not opts.coordinator:
        opts.coordinator = f"127.0.0.1:{_free_port()}"
    import torch.multiprocessing as mp

    # A child that raises makes spawn raise here: the run exits non-zero.
    mp.spawn(
        _worker, args=(opts, n_dev, avail, torch.get_num_threads()), nprocs=n_dev, join=True
    )
    return 0


def _worker(local_rank: int, opts, local_world: int, avail: int, threads: int) -> None:
    # The parent's CPU thread budget, shared by its processes.
    torch.set_num_threads(max(threads // local_world, 1))
    train(opts, local_rank, local_world, avail)


def train(opts, local_rank: int, local_world: int, avail: int) -> int:
    """One rank's run (the whole run with one process): joins the process
    group when there are several, trains, and leaves it."""
    from faster_rcnn_pytorch_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import wait_for_checkpoints
    from faster_rcnn_pytorch_tpu_torch.utils.logging import print0
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import select_device

    device = select_device(local_rank)
    mp = max(opts.model_parallel, 1)
    if local_world > 1 or opts.num_hosts > 1 or opts.coordinator:
        lay = mesh.init_distributed(
            local_rank, local_world, device, opts.num_hosts, opts.host_id,
            opts.coordinator, model_parallel=mp,
        )
    else:
        lay = mesh.layout()
    try:
        print0(
            f"devices: {lay.world}/{avail * opts.num_hosts} "
            f"(data {lay.data_size} x model {mp}), hosts: {opts.num_hosts}",
            flush=True,
        )
        if opts.eval_batch_size == 0:
            # one eval image per data rank of this host, as JAX sizes it
            opts.eval_batch_size = max(lay.local_data_size, 1)
        return _run(opts, lay, device)
    finally:
        wait_for_checkpoints()
        mesh.shutdown()


def _run(opts, lay, device) -> int:
    from faster_rcnn_pytorch_tpu_torch.data.loader import build_dataloader
    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate, label_map_for
    from faster_rcnn_pytorch_tpu_torch.engine.train import train_one_epoch
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, label_offset_for
    from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
    from faster_rcnn_pytorch_tpu_torch.parallel.train_step import (
        init_train_state,
        make_lr_schedule,
        make_optimizer,
        make_train_step,
    )
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        init_params,
        load_checkpoint,
        save_checkpoint,
    )
    from faster_rcnn_pytorch_tpu_torch.utils.logging import ScalarWriter, print0, trace_context
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import apply_matmul_precision, set_numerics

    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    autocast_dtype = dtype if dtype != torch.float32 else None

    train_loader, test_loader = build_dataloader(opts)
    model, cfg = build_model(
        opts.model_generation,
        opts.num_classes,
        label_offset=label_offset_for(opts.model_generation, opts.data_type),
        remat=opts.remat_backbone,
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

    if opts.checkpoint and not opts.checkpoint.endswith((".pth.tar", ".pth", ".pt")):
        raise ValueError(
            f"--checkpoint {opts.checkpoint!r}: the port reads .pth/.pth.tar "
            "weights, 'pretrained' or its own .pt train checkpoints"
        )
    # Before the split and DDP, so that every shard starts from these weights.
    print0(init_params(model, opts), flush=True)
    model = apply_tensor_parallel(model, lay.model_group, lay.model_rank, lay.model_parallel)
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
        print0(f"resumed from {path} (epoch {meta.get('epoch')})", flush=True)
    elif opts.checkpoint.endswith(".pt"):
        state, _ = load_checkpoint(opts.checkpoint, state)
        print0(f"loaded checkpoint {opts.checkpoint}", flush=True)

    accum = max(opts.grad_accum, 1)
    per_host_batch = max(opts.batch_size // opts.num_hosts, 1)
    local_data = max(lay.local_data_size, 1)
    if per_host_batch % (accum * local_data):
        raise SystemExit(
            f"--grad_accum {accum}: per-host batch {per_host_batch} must divide by "
            f"grad_accum x local data ranks ({accum} x {local_data})"
        )
    step_fn = make_train_step(cfg, schedule, grad_accum=accum, autocast_dtype=autocast_dtype)
    writer = ScalarWriter(opts.log_dir, opts.name, opts.log_backend)

    best_map = -1.0
    for epoch in range(opts.start_epoch, opts.epoch):
        with trace_context(
            f"{opts.log_dir}/{opts.name}/trace",
            enabled=opts.profile and epoch == opts.start_epoch and lay.rank == 0,
        ):
            state = train_one_epoch(
                state, step_fn, train_loader, epoch, opts, schedule, writer
            )
        result = evaluate(
            model,
            cfg,
            test_loader,
            data_type=opts.data_type,
            coco_index=coco_index,
            label_map=label_map,
            score_threshold=opts.thres,
            dtype=dtype,
        )
        writer.scalar("eval/mAP", result["map"], epoch)
        print0(f"epoch {epoch}: mAP = {result['map']:.4f}", flush=True)
        if result["map"] > best_map:  # the same merged mAP on every rank
            best_map = result["map"]
            save_checkpoint(
                checkpoint_path(opts.log_dir, opts.name, "best"),
                state,
                metadata={"epoch": epoch, "map": best_map},
                backend=opts.ckpt_backend,
                async_save=opts.async_checkpoint,
            )
    writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

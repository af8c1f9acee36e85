"""Evaluation CLI of the port (counterpart of ``faster_rcnn_pytorch_tpu/test.py``).

Same flags (``load_options``), on the CUDA cards, or on the CPU when
``FRT_TORCH_DEVICE=cpu`` asks for it (``utils.runtime.select_device``).
As the JAX CLI evaluates SPMD over the local devices, this one starts
``n = max((avail // mp) * mp, mp)`` processes for ``avail =
--num_devices`` (0: every card) and ``mp = --model_parallel``: each
predicts its rows of every batch (``--eval_batch_size`` 0: one image per
data rank) and the ranks' detections are merged before scoring
(``engine/evaluate.py``).
Weights as ``utils.checkpoint.resolve_and_load_params`` resolves them:
``--checkpoint x.pth.tar`` imports reference-layout weights
(``--checkpoint pretrained``: the released demo detector, from the cache
``FRT_CACHE_DIR`` or downloaded into it),
``--checkpoint x.pt`` loads a port train checkpoint (it must exist), and
without one the run's ``{log_dir}/{name}/saves/{name}.{test_epoch}.pt``
(as ``main`` writes it) is loaded, or, where it is missing, the detector
gets a fresh init seeded by ``--seed`` (its backbone from
``--pretrained_backbone`` if given) and a note says so. With several
processes the parent resolves both flags to files first, so that one
process a host downloads. Both generations
(``--model_generation legacy|fpn``) on VOC or COCO (``--data_type``);
COCO scores against ``annotations/instances_val2017.json`` under the
data root.

``python -m faster_rcnn_pytorch_tpu_torch.test --model_generation fpn --data_type coco --num_classes 91``
"""

from __future__ import annotations

import os
import sys


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
    mp = max(opts.model_parallel, 1)
    avail = device_count(opts.num_devices, select_device().type)
    n_dev = max((avail // mp) * mp, mp)
    resolve_weight_specs(opts)  # one fetch on this host; the ranks get paths
    if n_dev == 1:
        return run(opts, 0, 1)
    import torch
    import torch.multiprocessing as tmp

    from faster_rcnn_pytorch_tpu_torch.main import _free_port

    opts.coordinator = opts.coordinator or f"127.0.0.1:{_free_port()}"
    tmp.spawn(_worker, args=(opts, n_dev, torch.get_num_threads()), nprocs=n_dev, join=True)
    return 0


def _worker(local_rank: int, opts, local_world: int, threads: int) -> None:
    import torch

    torch.set_num_threads(max(threads // local_world, 1))
    run(opts, local_rank, local_world)


def run(opts, local_rank: int, local_world: int) -> int:
    """One rank's eval (the whole eval with one process)."""
    from faster_rcnn_pytorch_tpu_torch.data.loader import build_dataloader
    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate, label_map_for
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, label_offset_for
    from faster_rcnn_pytorch_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import resolve_and_load_params
    from faster_rcnn_pytorch_tpu_torch.utils.logging import print0
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        prepare_for_inference,
        select_device,
        set_numerics,
    )

    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    device = select_device(local_rank)
    mp = max(opts.model_parallel, 1)
    lay = mesh.layout()
    if local_world > 1:
        lay = mesh.init_distributed(
            local_rank, local_world, device, init_method=opts.coordinator, model_parallel=mp
        )
    try:
        if opts.eval_batch_size == 0:
            opts.eval_batch_size = lay.local_data_size
        _, test_loader = build_dataloader(opts, train_rows=False)
        model, cfg = build_model(
            opts.model_generation,
            opts.num_classes,
            label_offset=label_offset_for(opts.model_generation, opts.data_type),
        )
        print0(resolve_and_load_params(opts, model), flush=True)
        model = apply_tensor_parallel(model, lay.model_group, lay.model_rank, lay.model_parallel)
        model = prepare_for_inference(model, device, dtype)

        coco_index = None
        if opts.data_type == "coco":
            from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex

            coco_index = CocoIndex(
                os.path.join(opts.data_root, "annotations", "instances_val2017.json")
            )
        result = evaluate(
            model,
            cfg,
            test_loader,
            data_type=opts.data_type,
            coco_index=coco_index,
            label_map=label_map_for(opts, coco_index),
            score_threshold=opts.thres,
            dump_path=opts.dump_detections or None,
            dtype=dtype,
        )
        print0(f"mAP = {result['map']:.4f}", flush=True)
        return 0
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    sys.exit(main())

"""Evaluation CLI of the port (counterpart of ``faster_rcnn_pytorch_tpu/test.py``).

Same flags (``load_options``), one device: the CUDA card, or the CPU
when ``FRT_TORCH_DEVICE=cpu`` asks for it (``utils.runtime.select_device``).
Weights as ``utils.checkpoint.resolve_and_load_params`` resolves them:
``--checkpoint x.pth.tar`` imports reference-layout weights,
``--checkpoint x.pt`` loads a port train checkpoint (it must exist), and
without one the run's ``{log_dir}/{name}/saves/{name}.{test_epoch}.pt``
(as ``main`` writes it) is loaded, or, where it is missing, the detector
gets a fresh init seeded by ``--seed`` and a note says so. Both generations
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
    from faster_rcnn_pytorch_tpu_torch.data.loader import build_dataloader
    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate, label_map_for
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, label_offset_for
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import resolve_and_load_params
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        prepare_for_inference,
        refuse_unported,
        select_device,
        set_numerics,
    )

    opts = load_options(argv)
    refuse_unported(opts, "test")
    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    device = select_device()
    _, test_loader = build_dataloader(opts)
    model, cfg = build_model(
        opts.model_generation,
        opts.num_classes,
        label_offset=label_offset_for(opts.model_generation, opts.data_type),
    )

    print(resolve_and_load_params(opts, model), flush=True)
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
    )
    print(f"mAP = {result['map']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

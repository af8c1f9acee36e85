"""Evaluation CLI of the port (counterpart of ``faster_rcnn_pytorch_tpu/test.py``).

Same flags (``load_options``), one device: the CUDA card, or the CPU
when ``FRT_TORCH_DEVICE=cpu`` asks for it (``utils.runtime.select_device``).
``--checkpoint x.pth.tar`` loads reference-layout weights; without one
the detector gets a fresh init seeded by ``--seed``. Legacy generation
and VOC only, for now.

``python -m faster_rcnn_pytorch_tpu_torch.test --data_root ./data --dtype float32``
"""

from __future__ import annotations

import sys

import torch


def main(argv=None) -> int:
    # The JAX package's option parser and data loader are numpy/Pillow
    # host code with no jax import; the port reuses them on the CPU side.
    from faster_rcnn_pytorch_tpu.config import load_options
    from faster_rcnn_pytorch_tpu.data.loader import build_dataloader

    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, init_weights
    from faster_rcnn_pytorch_tpu_torch.utils.convert import load_legacy_checkpoint
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        prepare_for_inference,
        select_device,
        set_numerics,
    )

    opts = load_options(argv)
    if opts.data_type != "voc":
        raise NotImplementedError("only VOC evaluation is ported so far")
    dtype = set_numerics(opts.dtype)
    device = select_device()
    _, test_loader = build_dataloader(opts)
    model, cfg = build_model(opts.model_generation, opts.num_classes)

    if opts.checkpoint.endswith((".pth.tar", ".pth")):
        model.load_state_dict(load_legacy_checkpoint(opts.checkpoint), strict=True)
        print(f"imported torch checkpoint {opts.checkpoint}", flush=True)
    elif opts.checkpoint:
        raise ValueError(
            f"--checkpoint {opts.checkpoint!r}: the port reads .pth/.pth.tar only"
        )
    else:
        init_weights(model, torch.Generator().manual_seed(opts.seed))
        print(f"no checkpoint; fresh init with seed {opts.seed}", flush=True)
    model = prepare_for_inference(model, device, dtype)

    result = evaluate(
        model,
        cfg,
        test_loader,
        score_threshold=opts.thres,
        dump_path=opts.dump_detections or None,
    )
    print(f"mAP = {result['map']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

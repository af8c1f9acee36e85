"""Demo CLI of the port (counterpart of ``faster_rcnn_pytorch_tpu/demo.py``).

``python -m faster_rcnn_pytorch_tpu_torch.demo --data_type voc \
      --demo_root ./demo --thres 0.5``

Same flags (``load_options``), one device (``utils.runtime.select_device``:
the card, or the CPU under ``FRT_TORCH_DEVICE=cpu``). Weights as the
``test`` CLI resolves them; the model runs at ``--dtype``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from faster_rcnn_pytorch_tpu_torch.config import load_options
    from faster_rcnn_pytorch_tpu_torch.engine.demo import demo
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import load_detector
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        prepare_for_inference,
        select_device,
        set_numerics,
    )

    opts = load_options(argv)
    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    device = select_device()
    model, cfg, note = load_detector(opts)
    print(note, flush=True)
    demo(prepare_for_inference(model, device, dtype), cfg, opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())

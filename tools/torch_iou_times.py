#!/usr/bin/env python3
"""Time the port's IoU kernel at the dense train shapes on one CUDA card.

    python tools/torch_iou_times.py [--root CHECKOUT]

``--root`` names the checkout whose ``faster_rcnn_pytorch_tpu_torch`` and
``chip_smoke.py`` to load (default: this one), so that one call on the card
can time two trees, each built from its own sources (``build/`` under
``CHECKOUT``). With the inputs of ``chip_smoke.iou_boxes`` (a two-image
batch, 400 real gt an image, 10% of the proposals invalid), eps 1e-5, at
[2512, 4] x [512, 4] (legacy, ``--max_gt`` 512) and [1640, 4] x [640, 4]
(FPN, 640), it prints one JSON line per shape with medians of 25 of

* ``matrix_ms`` / ``matrix_burst_ms``: ``pairwise_iou_cuda`` on image 0,
  one call between two CUDA events / ``chip_smoke.BURST`` calls back to
  back, over ``BURST``;
* ``chain_ms`` / ``chain_burst_ms``: ``frcnn_targets``' use of the IoU for
  the batch as the tree runs it on the card: per image ``masked_iou``,
  ``where`` on the candidates' validity, ``max``; a tree with the match
  mode also times it (``match_ms`` / ``match_burst_ms``: ``roi_match``, one
  launch for the batch);
* ``floor_ms`` / ``floor_burst_ms``: an empty kernel, where the tree's
  extension has one.

It needs a card and exits non-zero without one; the card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_iou_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from faster_rcnn_pytorch_tpu_torch.models import targets
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import FPN_CONFIG, LEGACY_CONFIG
    from faster_rcnn_pytorch_tpu_torch.ops import boxes
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    ext = extension()
    g = torch.Generator().manual_seed(smoke.SEED + 9)
    burst = smoke.BURST
    eps = 1e-5
    for generation, n_props, max_gt in (
        ("legacy", LEGACY_CONFIG.post_nms_train, smoke.DENSE_MAX_GT),
        ("fpn", FPN_CONFIG.post_nms_train, smoke.FPN_DENSE_MAX_GT),
    ):
        pairs = [smoke.iou_boxes(g, n_props, max_gt, 400) for _ in range(2)]
        cand = torch.stack([c for c, _ in pairs]).to(device)
        gt = torch.stack([t for _, t in pairs]).to(device)
        gt_mask = (torch.arange(max_gt, device=device) < 400).expand(2, max_gt).contiguous()
        roi_valid = torch.rand(2, n_props, generator=g).to(device) > 0.1
        cand_valid = torch.cat([roi_valid, gt_mask], 1)

        def chain():
            for i in range(2):
                iou = boxes.masked_iou(cand[i], gt[i], gt_mask[i], eps)
                torch.where(cand_valid[i][:, None], iou, -1.0).max(dim=1)

        def timed(fn):
            return smoke._median_ms(fn), smoke._median_ms(fn, burst=burst)

        row = {"tree": os.path.abspath(args.root), "shape": generation, "n": cand.shape[1], "m": max_gt}
        row["matrix_ms"], row["matrix_burst_ms"] = timed(lambda: boxes.pairwise_iou_cuda(cand[0], gt[0], eps))
        row["chain_ms"], row["chain_burst_ms"] = timed(chain)
        if hasattr(targets, "roi_match"):
            row["match_ms"], row["match_burst_ms"] = timed(
                lambda: targets.roi_match(cand, cand_valid, gt, gt_mask)
            )
        if hasattr(ext, "empty_kernel"):
            row["floor_ms"], row["floor_burst_ms"] = timed(ext.empty_kernel)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's RPN anchor match kernel at the main path's six shapes on one CUDA card.

    python tools/torch_rpn_match_times.py [--root CHECKOUT] [--out FILE]

``--root`` names the checkout whose ``faster_rcnn_pytorch_tpu_torch`` and
``chip_smoke.py`` to load (default: this one), so that one call on the card
can time two trees, each built from its own sources (``build/`` under
``CHECKOUT``). The operands are made here, the same for every tree, as the
train step hands them over (``chip_smoke.synthetic_train_batch`` scenes with
the seeds of ``chip_smoke.check_rpn_match_kernel``, each generation's anchors
and inside mask): FPN at 800x1344 with 2 x 640 and 2 x 100 gt slots
(``ties``), legacy with 2 x 512 and 2 x 100 (``argmax``, the boundary
filter), and both at the shapes recipe's 320x512 canvas, 8 x 100 slots. For
each it prints one JSON line with medians of 25 of

* ``ms`` / ``burst_ms``: ``rpn_match_cuda`` on the batch, one call between
  two CUDA events / ``chip_smoke.BURST`` calls back to back, over ``BURST``;
* ``host_ms``: the host's time to issue one call, over 200 calls issued
  without waiting for the card (the host path of a call: the wrapper, the
  binding's checks and allocations, the launches);
* ``floor_ms`` / ``floor_burst_ms``: an empty kernel, where the tree's
  extension has one;
* ``plan``: the tree's launch plan (``ops/boxes.py::rpn_match_launch_plan``),
  where it has one;

after checking the kernel's outputs against the tree's plain twin
(``iou_max`` bit for bit). ``--out`` appends the lines to a file as well.
It needs a card and exits non-zero without one; the card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (name, generation, canvas, images, gt slots, real boxes an image [low, high), seed offset):
# chip_smoke.RPN_MATCH_SHAPES with check_rpn_match_kernel's seeds.
SHAPES = (
    ("fpn 640", "fpn", (800, 1344), 2, 640, (300, 501), 30),
    ("fpn 100", "fpn", (800, 1344), 2, 100, (1, 4), 31),
    ("legacy 512", "legacy", (800, 1344), 2, 512, (300, 501), 32),
    ("legacy 100", "legacy", (800, 1344), 2, 100, (1, 4), 33),
    ("fpn 320x512", "fpn", (320, 512), 8, 100, (1, 4), 34),
    ("legacy 320x512", "legacy", (320, 512), 8, 100, (1, 4), 35),
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_rpn_match_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from faster_rcnn_pytorch_tpu_torch.models.anchors import fpn_anchors, legacy_anchors
    from faster_rcnn_pytorch_tpu_torch.models.targets import anchor_inside
    from faster_rcnn_pytorch_tpu_torch.ops import boxes
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    ext = extension()
    for name, generation, canvas, batch, max_gt, n_boxes, offset in SHAPES:
        cfg, labels = smoke._train_setup(generation)
        anchors = legacy_anchors(*canvas) if generation == "legacy" else fpn_anchors(*canvas)
        anchors = torch.from_numpy(anchors).to(device)
        b = smoke.synthetic_train_batch(
            canvas, smoke.SEED + offset, batch=batch, labels=labels, max_gt=max_gt, boxes=n_boxes
        )
        gt, gt_mask, extents = (torch.from_numpy(b[k]).to(device) for k in ("gt_boxes", "gt_mask", "extent"))
        inside = anchor_inside(anchors, extents, cfg.rpn_boundary_filter)
        ties = cfg.rpn_allow_ties

        def call():
            return boxes.rpn_match_cuda(anchors, gt, gt_mask, inside, ties)

        got, want = call(), boxes.rpn_match_reference(anchors, gt, gt_mask, inside, ties)
        if not (
            torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        ):
            print(f"torch_rpn_match_times: {name} differs from the plain twin", file=sys.stderr)
            return 1
        row = {"tree": os.path.abspath(args.root), "shape": name, "anchors": anchors.shape[0],
               "images": batch, "slots": max_gt, "ties": ties, "card": card}
        row["ms"], row["burst_ms"] = smoke._median_ms(call), smoke._median_ms(call, burst=smoke.BURST)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        row["host_ms"] = 1e3 * (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        if hasattr(ext, "empty_kernel"):
            empty = ext.empty_kernel
            row["floor_ms"], row["floor_burst_ms"] = smoke._median_ms(empty), smoke._median_ms(empty, burst=smoke.BURST)
        if hasattr(boxes, "rpn_match_launch_plan"):
            row["plan"] = boxes.rpn_match_launch_plan(anchors, gt)._asdict()
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

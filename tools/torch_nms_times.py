#!/usr/bin/env python3
"""Time the port's NMS kernel at every call site on one CUDA card.

    python tools/torch_nms_times.py [--root CHECKOUT] [--runs 25]

``--root`` names the checkout whose ``faster_rcnn_pytorch_tpu_torch`` and
``chip_smoke.py`` to load (default: this one), so that one call on the card
can time two trees, each built from its own sources (``build/`` under
``CHECKOUT``). On the inputs of ``chip_smoke.nms_segments_inputs`` at each
row of ``chip_smoke.NMS_SITES`` it checks the kernel against the plain sweep
(keep and counts identical, or it exits non-zero) and prints one JSON line
per site with medians of ``--runs`` of

* ``ms`` / ``burst_ms``: the kernel's wrapper, one call between two CUDA
  events / ``chip_smoke.BURST`` calls back to back, over ``BURST``;
* ``width``: the cluster width the tree's launch plan picks (1 for a tree
  without one), and, where the wrapper takes a width, ``width_ms``: one
  call at each of the widths 1, 8 and 16;
* ``floor_ms`` / ``floor_burst_ms``: an empty kernel (the launch floor).

It needs a card and exits non-zero without one; the card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--runs", type=int, default=25)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_nms_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from faster_rcnn_pytorch_tpu_torch.ops import nms as nms_mod
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    ext = extension()
    kernel = nms_mod.nms_segments_cuda
    has_width = "width" in inspect.signature(kernel).parameters
    floor = (smoke._median_ms(ext.empty_kernel, runs=args.runs),
             smoke._median_ms(ext.empty_kernel, runs=args.runs, burst=smoke.BURST))
    for i, (what, s, n, post_k, thr, tile) in enumerate(smoke.NMS_SITES):
        shift = smoke.NUM_CLASSES - 1 if "offset" in what else 0
        boxes, valid = smoke.nms_segments_inputs(smoke.SEED + 20 + i, s, n, shift, "compact" in what)
        tb, tv = torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)
        keep, count = kernel(tb, tv, thr, post_k)
        want_keep, want_count = nms_mod.nms_segments_reference(tb, tv, thr, post_k, tile)
        if not (torch.equal(keep, want_keep) and torch.equal(count, want_count)):
            print(f"torch_nms_times: {what}: the kernel differs from the plain sweep", file=sys.stderr)
            return 1
        call = lambda: kernel(tb, tv, thr, post_k)  # noqa: E731
        row = {"tree": os.path.abspath(args.root), "site": what, "segments": s, "n": n, "post_k": post_k}
        row["ms"] = smoke._median_ms(call, runs=args.runs)
        row["burst_ms"] = smoke._median_ms(call, runs=args.runs, burst=smoke.BURST)
        row["width"] = nms_mod.launch_plan(device, s, post_k).width if has_width else 1
        if has_width:
            row["width_ms"] = {
                w: smoke._median_ms(lambda: kernel(tb, tv, thr, post_k, width=w), runs=args.runs)
                for w in (1, 8, 16)
            }
        row["floor_ms"], row["floor_burst_ms"] = floor
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

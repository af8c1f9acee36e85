#!/usr/bin/env python3
"""Time and profile the port's ResNet50-FPN trunk alone on one CUDA card.

    python tools/torch_trunk_profile.py [--root CHECKOUT] [--batch 8] [--out FILE]

``--root`` names the checkout whose ``faster_rcnn_pytorch_tpu_torch`` to
load (default: this one), so that one call on the card can profile two
trees, e.g. a parent unpacked under ``build/`` and this one. With seeded
weights (``torch.manual_seed(0)``) and a seeded input of ``--batch``
images at 800x1344, TF32 off and cuDNN's default algorithms, it runs

* ``predict_forward``: the trunk under ``no_grad`` with bfloat16 conv
  weights and a bfloat16 input (FrozenBN's buffers stay float32), as
  ``prepare_for_inference`` holds the model;
* ``train_fwd_bwd``: the float32 trunk under bfloat16 autocast, then the
  backward of the sum of its outputs' means (the stem and ``layer1`` are
  detached, as in training);

and prints for each the median of 10 calls between two CUDA events
(``ms``), for the forward also the host's time to enqueue one call
(``host_enqueue_ms``, median of 10), and ``torch.profiler``'s device
kernels over 5 calls: their summed time a call (``device_ms_sum``) and
the 14 longest, each as (ms a call, launches a call, full kernel name).
``--out`` appends the results as one JSON line. It needs a card and
exits non-zero without one; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CANVAS = (800, 1344)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_trunk_profile: no CUDA device", file=sys.stderr)
        return 1
    from faster_rcnn_pytorch_tpu_torch.models.resnet import ResNet50FPN

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.manual_seed(0)
    model = ResNet50FPN().to(device)
    x32 = torch.randn(args.batch, 3, *CANVAS, device=device)
    pmodel = ResNet50FPN().to(device)
    pmodel.load_state_dict(model.state_dict())
    for m in pmodel.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(torch.bfloat16)
    xb = x32.to(torch.bfloat16)

    def predict_forward():
        with torch.no_grad():
            pmodel(xb)

    def train_fwd_bwd():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            outs = model(x32)
        sum(o.float().mean() for o in outs).backward()

    def median_ms(fn, n=10):
        for _ in range(3):
            fn()
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def host_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
        return statistics.median(times)

    def top_kernels(fn, calls=5, k=14):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if t and e.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((t / 1e3 / calls, e.count // calls, e.key))
        rows.sort(reverse=True)
        return rows[:k], sum(r[0] for r in rows)

    result = {"root": os.path.abspath(args.root), "card": card, "batch": args.batch}
    for name, fn in (("predict_forward", predict_forward), ("train_fwd_bwd", train_fwd_bwd)):
        ms = median_ms(fn)
        enqueue = host_ms(fn) if name == "predict_forward" else None
        rows, total = top_kernels(fn)
        result[name] = {"ms": ms, "host_enqueue_ms": enqueue, "device_ms_sum": total, "top": rows}
        print(
            f"[{args.root}] {name}: {ms:.3f} ms (CUDA events, median of 10), device kernels {total:.3f} ms"
            + (f", host enqueue {enqueue:.3f} ms" if enqueue else ""),
            flush=True,
        )
        for t, count, key in rows:
            print(f"   {t:8.3f} ms  x{count:<4d} {key[:220]}", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the port's predict spends its time on one GPU.

Runs either generation's full-width predict (``--generation fpn``:
ResNet50-FPN, 91 classes; ``legacy``: VGG16, 21 classes) with seeded
random weights (``init_weights``, seed 0) on seeded normalised images at
the 800x1344 canvas (``canvas_buckets(800, 1333)[0]``), batch
``--batch`` (2 for fpn, 1 for legacy), extents (1, 1) and (0.9, 0.75)
alternating, the config's own budgets (100 detections per image; the
VOC eval keeps every per-class survivor instead), cuDNN deterministic as
``chip_smoke.py`` runs it, and prints per dtype (float32 with TF32 off, bfloat16):

1. rate: ``--batches`` predict calls after two warm-up calls, each timed
   to a device sync: img/s and the p50 per call;
2. stages: the same ``predict`` calls with a device sync as each of its
   stages ends (``PREDICT_STAGES``): the host-to-device copy of images
   and anchors, the backbone, the RPN head, propose (per image), the RoI
   head (RoIPool or MultiScaleRoIAlign, fc6/fc7), softmax + decode, and
   the per-class NMS: the median ms per image of each, and how many
   (class, roi) pairs cleared the score threshold (over 512, the
   per-class NMS runs once per class);
3. busy share: ``torch.profiler`` over 2 whole predict calls, device
   kernel time over wall time (the profiler's overhead included), and the
   five kernels with the most device time.

Rates run before the first profiler session. Run on a GPU host:
``python -m faster_rcnn_pytorch_tpu_torch.tools.predict_stages
[--generation fpn] [--batches 8]``. Without a card it raises; with
``FRT_TORCH_DEVICE=cpu``, ``--canvas 128 192`` checks the script itself
on the CPU (without the profiler).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (
    PREDICT_STAGES,
    build_model,
    init_weights,
    predict,
)
from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
    prepare_for_inference,
    select_device,
    set_numerics,
)


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def make_batches(n: int, batch: int, canvas, seed: int = 0):
    """``n`` host batches ``(images [B, H, W, 3], extents [B, 2])``: normal
    pixels inside each image's extent, zeros beyond (the padded canvas)."""
    rng = np.random.default_rng(seed)
    h, w = canvas
    out = []
    for _ in range(n):
        images = np.zeros((batch, h, w, 3), np.float32)
        extents = np.zeros((batch, 2), np.float32)
        for i in range(batch):
            ex, ey = (1.0, 1.0) if i % 2 == 0 else (0.9, 0.75)
            rh, rw = int(h * ey), int(w * ex)
            images[i, :rh, :rw] = rng.standard_normal((rh, rw, 3), dtype=np.float32)
            extents[i] = (ex, ey)
        out.append((torch.from_numpy(images), torch.from_numpy(extents)))
    return out


def staged_predict(model, cfg, images, extents, device, times: dict) -> int:
    """One ``predict`` call with a device sync as each stage ends; adds each
    stage's seconds per image to ``times`` and returns the number of
    (class, roi) pairs above the score threshold per image."""
    b = images.shape[0]
    stamps = [_sync(device)]
    above = []

    def on_stage(name, result):
        stamps.append(_sync(device))
        if name == "decode":
            above.append(int((result[:, :, 1:] > cfg.score_threshold).sum()) // b)

    predict(model, cfg, images.to(device), extents.to(device), on_stage=on_stage)
    for name, t0, t1 in zip(PREDICT_STAGES, stamps, stamps[1:]):
        times.setdefault(name, []).append((t1 - t0) / b)
    return above[0]


def run_rate(model, cfg, batches, device) -> None:
    for images, extents in batches[:2]:
        predict(model, cfg, images.to(device), extents.to(device))
    times = []
    for images, extents in batches:
        t0 = _sync(device)
        predict(model, cfg, images.to(device), extents.to(device))
        times.append(_sync(device) - t0)
    n = sum(images.shape[0] for images, _ in batches)
    print(
        f"  rate: {n / sum(times):.2f} img/s over {len(batches)} calls "
        f"(p50 {1000 * statistics.median(times):.1f} ms per call of {batches[0][0].shape[0]})",
        flush=True,
    )


def run_stages(model, cfg, batches, device) -> None:
    times: dict = {}
    above = [staged_predict(model, cfg, im, ex, device, times) for im, ex in batches]
    med = {k: 1000 * statistics.median(v) for k, v in times.items()}
    print(
        "  ms per image: "
        + " ".join(f"{k}={med[k]:.2f}" for k in PREDICT_STAGES)
        + f" total={sum(med.values()):.2f}; (class, roi) pairs above threshold per image "
        f"{min(above)}-{max(above)}",
        flush=True,
    )


def run_profile(model, cfg, batches, device) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = _sync(device)
        for images, extents in batches[:2]:
            predict(model, cfg, images.to(device), extents.to(device))
        wall = _sync(device) - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # Kernels and copies only: user annotations also show as device time.
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in events)
    n = sum(images.shape[0] for images, _ in batches[:2])
    print(
        f"  profile: {1000 * wall / n:.2f} ms per image (profiler on), device kernel time "
        f"{busy_us / 1000 / n:.2f} ms per image, busy share {busy_us / 1e6 / wall:.3f}",
        flush=True,
    )
    for e in sorted(events, key=device_us, reverse=True)[:5]:
        print(f"    {device_us(e) / 1000 / n:8.3f} ms/img  {e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generation", choices=("fpn", "legacy"), default="fpn")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0, help="0: 2 for fpn, 1 for legacy")
    ap.add_argument("--canvas", type=int, nargs=2, default=(800, 1344))
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args(argv)
    device = select_device()
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(card, flush=True)
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
    else:
        print("on the CPU: checks the script only (no device numbers)", flush=True)
    batch = args.batch or (2 if args.generation == "fpn" else 1)
    batches = make_batches(args.batches, batch, tuple(args.canvas))
    for dtype_name in args.dtypes.split(","):
        dtype = set_numerics(dtype_name)
        model, cfg = build_model(args.generation, 91 if args.generation == "fpn" else 21)
        init_weights(model, torch.Generator().manual_seed(0))
        model = prepare_for_inference(model, device, dtype)
        print(
            f"{args.generation} predict {dtype_name} {args.canvas[0]}x{args.canvas[1]} "
            f"batch {batch}:",
            flush=True,
        )
        run_rate(model, cfg, batches, device)
        run_stages(model, cfg, batches, device)
    if device.type == "cuda":
        for dtype_name in args.dtypes.split(","):
            dtype = set_numerics(dtype_name)
            model, cfg = build_model(args.generation, 91 if args.generation == "fpn" else 21)
            init_weights(model, torch.Generator().manual_seed(0))
            model = prepare_for_inference(model, device, dtype)
            print(f"{args.generation} predict {dtype_name}, profiled:", flush=True)
            run_profile(model, cfg, batches, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

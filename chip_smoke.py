#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, builds the port's kernels from the sources in the checkout
(into ``build/torch_kernels/``) and exits non-zero if any phase fails:

1. device: a CUDA card is present; prints its name and power limit.
2. kernels: each hand-written kernel against its plain PyTorch version at
   the legacy predict shapes (RoIPool: feats [1, 512, 50, 84], rois
   [1, 300, 4] plus edge rois; float32 and bfloat16; values and argmax
   must be bit-exact), timed with CUDA events (median of 25 runs).
3. main path: full-width legacy VGG16 predict (21 classes, seeded random
   weights, the 800x1344 canvas, batch 1) through the port's
   ``engine.evaluate.evaluate`` on synthetic in-memory VOC batches, in
   float32 (TF32 off) and bfloat16, with every kernel's launch count
   reset just before and read just after.
4. slice vs plain: the same float32 predict with RoIPool forced to the
   plain version must give identical detections.
5. small-input reference: GPU float32 predict against the CPU plain path
   on a 128x192 canvas, greedy-matched (label, IoU >= 0.99, 99% matched,
   score and box |d| <= 1e-4).
6. imports: jax and flax were never imported.

Its last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate
from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (
    LEGACY_CONFIG,
    build_model,
    init_weights,
    predict,
)
from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as roi_pool_mod
from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension
from faster_rcnn_pytorch_tpu_torch.utils.runtime import prepare_for_inference, set_numerics

CANVAS = (800, 1344)  # canvas_buckets(800, 1333)[0]
NUM_CLASSES = 21
N_IMAGES = 8
THRESHOLD = 0.05
SEED = 0


class SyntheticVOC:
    """Loader-like stand-in: ``epoch(0)`` yields the JAX loader's batch
    dicts (batch 1) of seeded normalised images on the padded canvas. The
    images are made up front, so a timed pass measures predict, not the
    random number generator."""

    batch_size = 1

    def __init__(self, n: int, canvas: tuple[int, int], seed: int):
        self.n, self.canvas = n, canvas
        rs = np.random.RandomState(seed)
        pixels = np.random.default_rng(seed)
        ch, cw = canvas
        self.items = []
        self.batches = []
        self.records_by_id = {}
        for i in range(n):
            rh = ch if i % 2 == 0 else int(ch * 0.75)
            rw = int(cw * (0.9 - 0.1 * (i % 3)))
            orig = (int(rh * 0.6), int(rw * 0.6))
            k = rs.randint(1, 4)
            xy = rs.uniform(0, 0.6, size=(k, 2)) * orig[::-1]
            wh = rs.uniform(0.1, 0.4, size=(k, 2)) * orig[::-1]
            boxes = np.concatenate([xy, np.minimum(xy + wh, orig[::-1])], 1)
            self.records_by_id[i] = SimpleNamespace(
                boxes=boxes.astype(np.float32),
                labels=rs.randint(0, NUM_CLASSES - 1, size=k).astype(np.int32),
                difficult=np.zeros(k, bool),
            )
            self.items.append((i, (rh, rw), orig))
            image = np.zeros((1, ch, cw, 3), np.float32)
            image[0, :rh, :rw] = pixels.standard_normal((rh, rw, 3), dtype=np.float32)
            self.batches.append(
                {
                    "image": image,
                    "extent": np.array([[rw / cw, rh / ch]], np.float32),
                    "image_id": np.array([i], np.int64),
                    "orig_hw": np.array([orig], np.int32),
                    "resized_hw": np.array([[rh, rw]], np.int32),
                }
            )

    def epoch(self, epoch: int = 0):
        yield from self.batches


def _median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _edge_rois(h: int, w: int) -> torch.Tensor:
    return torch.tensor(
        [
            [0.0, 0.0, 0.0, 0.0],  # degenerate
            [3.5, 2.5, 3.5, 2.5],  # degenerate at .5 corners
            [w - 0.5, h - 0.5, w, h],  # touching the far border
            [0.0, 0.0, w, h],  # the whole map (extent = size + 1)
            [-5.0, -5.0, w + 16.0, h + 20.0],  # extent beyond the map
            [2.5, 1.5, 5.5, 4.5],  # .5 corners: round half to even
            [10.5, 0.5, 20.5, h - 0.5],
        ],
        dtype=torch.float32,
    )


def check_roi_pool_kernel(device) -> dict:
    t0 = time.time()
    extension()
    print(f"kernel build: {time.time() - t0:.1f}s", flush=True)
    h, w = CANVAS[0] // 16, CANVAS[1] // 16
    g = torch.Generator().manual_seed(SEED)
    feats = torch.relu(torch.randn(1, 512, h, w, generator=g))
    xy = torch.rand(1, 300, 2, generator=g) * torch.tensor([w - 4.0, h - 4.0])
    wh = torch.rand(1, 300, 2, generator=g) * torch.tensor([w / 2.0, h / 2.0])
    rois = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w * 1.0, h * 1.0]))], -1)
    rois[0, : len(_edge_rois(h, w))] = _edge_rois(h, w)
    rois = rois.to(device)
    record = {
        "name": "roi_pool_forward",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/roi_pool.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/roi_pool_kernel.py:30",
    }
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.to(device, dtype)
        out, arg = roi_pool_mod.roi_pool_cuda(f, rois, 1.0, 7, with_argmax=True)
        torch.cuda.synchronize()
        ref, ref_arg = roi_pool_mod.roi_pool_reference(f, rois, 1.0, 7, with_argmax=True)
        diff = float((out.float() - ref.float()).abs().max())
        _require(
            torch.equal(out, ref) and torch.equal(arg, ref_arg),
            f"roi_pool kernel != plain ({dtype}): max|d| {diff}",
        )
        err = max(err, diff)
        ms = _median_ms(lambda: roi_pool_mod.roi_pool_cuda(f, rois, 1.0, 7))
        plain_ms = _median_ms(lambda: roi_pool_mod.roi_pool_reference(f, rois, 1.0, 7))
        name = str(dtype).removeprefix("torch.")
        print(
            f"roi_pool {name} feats {tuple(f.shape)} rois {tuple(rois.shape)}: bit-exact "
            f"(values and argmax), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)",
            flush=True,
        )
        if dtype == torch.float32:
            record.update(ms=ms, plain_ms=plain_ms)
    record["max_abs_err"] = err
    return record


def _detections_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[i][k], b[i][k]) for i in a for k in ("boxes", "labels", "scores")
    )


def _require(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _check_outputs(result: dict, loader: SyntheticVOC) -> int:
    n_det = 0
    for img_id, det in result["detections"].items():
        _, (rh, rw), (oh, ow) = loader.items[img_id]
        ch, cw = loader.canvas
        boxes, labels, scores = det["boxes"], det["labels"], det["scores"]
        _require(boxes.ndim == 2 and boxes.shape[1] == 4, f"boxes {boxes.shape}")
        _require(np.isfinite(boxes).all() and np.isfinite(scores).all(), "non-finite output")
        # boxes are clamped to the canvas, in original-image pixels
        _require(
            (boxes >= 0).all()
            and (boxes[:, [0, 2]] <= cw * ow / rw * 1.0001).all()
            and (boxes[:, [1, 3]] <= ch * oh / rh * 1.0001).all(),
            "boxes outside the canvas",
        )
        _require(((labels >= 0) & (labels < NUM_CLASSES - 1)).all(), "label out of range")
        _require(((scores > THRESHOLD) & (scores <= 1.0)).all(), "score out of range")
        n_det += len(scores)
    _require(result["n_images"] == loader.n, f"{result['n_images']} of {loader.n} images")
    return n_det


def run_predict(model, dtype_name: str, device, canvas, plain_roi_pool=False, n_images=N_IMAGES):
    dtype = set_numerics(dtype_name)
    model = prepare_for_inference(model, device, dtype)
    loader = SyntheticVOC(n_images, canvas, SEED)
    result = evaluate(
        model,
        LEGACY_CONFIG,
        loader,
        score_threshold=THRESHOLD,
        plain_roi_pool=plain_roi_pool,
        verbose=False,
    )
    n_det = _check_outputs(result, loader)
    print(
        f"predict {dtype_name}{' plain-roipool' if plain_roi_pool else ''} "
        f"{canvas[0]}x{canvas[1]}: {result['n_images'] / result['seconds']:.2f} img/s, "
        f"{n_det} detections, mAP = {result['map']:.4f}",
        flush=True,
    )
    return result, n_det


def _new_model():
    model, _ = build_model("legacy", NUM_CLASSES)
    return init_weights(model, torch.Generator().manual_seed(SEED))


def check_small_input_reference(device):
    """GPU float32 predict vs the CPU plain path on a small canvas."""
    canvas = (128, 192)
    cfg = LEGACY_CONFIG
    set_numerics("float32")
    loader = SyntheticVOC(2, canvas, SEED + 1)
    cpu_model = prepare_for_inference(_new_model(), torch.device("cpu"), torch.float32)
    gpu_model = prepare_for_inference(_new_model(), device, torch.float32)
    for batch in loader.epoch(0):
        images = torch.from_numpy(batch["image"])
        extents = torch.from_numpy(batch["extent"])
        want = predict(cpu_model, cfg, images, extents, THRESHOLD)
        got = predict(gpu_model, cfg, images.to(device), extents.to(device), THRESHOLD)
        ok, summary = detections_agree(_valid(got), _valid(want), score_tol=1e-4, box_tol=1e-4)
        _require(ok, f"GPU vs CPU on {canvas}: {summary}")
        print(f"small input {canvas}: GPU vs CPU plain path, {summary}", flush=True)


def _valid(det) -> dict:
    ok = det.valid[0].cpu().numpy()
    return {k: getattr(det, k)[0].cpu().numpy()[ok] for k in ("boxes", "labels", "scores")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    # Deterministic cuDNN algorithms: phase 4 compares two float32 runs bit for bit.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True

    record = check_roi_pool_kernel(device)

    launches = 0
    detections = {}
    for dtype_name in ("float32", "bfloat16"):
        model = _new_model()
        # Warm-up (cuDNN and cuBLAS handles, first launches), outside the counts.
        run_predict(model, dtype_name, device, CANVAS, n_images=1)
        roi_pool_mod.roi_pool_cuda.launches = 0
        result, n_det = run_predict(model, dtype_name, device, CANVAS)
        count = roi_pool_mod.roi_pool_cuda.launches
        _require(count > 0, f"{dtype_name} predict never launched the RoIPool kernel")
        if dtype_name == "float32":
            _require(n_det > 0, "float32 predict found no detections to compare")
            detections = result["detections"]
        launches += count
    record["launches"] = launches

    roi_pool_mod.roi_pool_cuda.launches = 0
    plain, _ = run_predict(_new_model(), "float32", device, CANVAS, plain_roi_pool=True)
    _require(roi_pool_mod.roi_pool_cuda.launches == 0, "the plain-RoIPool run launched the kernel")
    _require(
        _detections_equal(plain["detections"], detections),
        "float32 detections differ between kernel and plain RoIPool",
    )
    print("float32 detections identical with the kernel and with plain RoIPool", flush=True)

    check_small_input_reference(device)

    leaked = [m for m in ("jax", "flax") if m in sys.modules]
    _require(not leaked, f"imported {leaked}")

    print(json.dumps({"kernels": [record]}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

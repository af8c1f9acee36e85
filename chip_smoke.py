#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, builds the port's kernels from the sources in the checkout
(into ``build/torch_kernels/``) and exits non-zero if any phase fails:

1. device: a CUDA card is present; prints its name and power limit.
2. kernels: each hand-written kernel against its plain PyTorch version,
   timed with CUDA events (median of 25 runs), with its bound (the least
   time for the bytes this run's data needs at 3.35 TB/s, or its
   operations at 67 TFLOP/s float32, whichever is larger):
   * RoIPool forward at the legacy predict shapes (feats [1, 512, 50, 84],
     rois [1, 300, 4] plus edge rois; float32 and bfloat16; values and
     argmax bit-exact);
   * RoIPool backward at the legacy train shapes (feats [2, 512, 50, 84],
     128 rois per image plus edge rois inside the map, argmax from the
     forward kernel): integer-valued gradients bit-exact in float32 and
     bfloat16, normal ones within 1e-5 * max|ref| (atomics add in another
     order); ``scatter_add_`` on the prepared index is timed beside it;
   * MultiScaleRoIAlign forward at the FPN predict shapes (P2..P5
     [2, 256, 200, 336] .. [2, 256, 25, 42], 1000 rois per image plus
     extremes: banners, poles, degenerate, giant, partly outside),
     float32 and bfloat16, bit-exact;
   * MultiScaleRoIAlign backward at the FPN train shapes (the same
     levels, 512 rois per image plus the extremes): on rois whose extent
     at their level is a whole multiple of 7 cells from a cell edge (every
     weight a multiple of 1/16) integer gradients are bit-exact in float32
     and bfloat16, normal ones within 1e-5 * max|ref| of the float32 maps
     (atomics add in another order); ``index_put_`` with ``accumulate`` on
     the plain version's prepared terms is timed beside it;
   * IoU at the dense train shapes ([2512, 4] x [512, 4], legacy at
     ``--max_gt`` 512, and [1640, 4] x [640, 4], FPN at 640: proposals
     around 400 small gt boxes, random, degenerate and coincident ones,
     padded zero gt rows), eps 1e-5 and eps 0 (zero-area pairs hit the
     1e-12 union floor), bit-exact;
   * the slot-lattice MultiScaleRoIAlign forward (no main path runs it) on
     the forward's predict shapes and rois, float32 and bfloat16: bit-exact
     with its plain version, within 1e-5 * max|ref| of the forward kernel
     (one bfloat16 ulp more in bfloat16), bound as the forward's. Its
     count is set to 0 after this check and never reset: phases 3, 6, 9,
     12 and 15 each require it still 0, and its record's ``launches`` is
     the count read after phase 16;
   * the three align kernels on rois whose footprints stress their
     per-roi geometry (``footprint_rois``: giant rois on P5, rois partly or
     wholly outside the canvas, degenerate rois, 64 rois sharing one cell):
     both forwards bit-exact in float32 and bfloat16, the backward within
     1e-5 * max|ref| and bit-exact on 64 copies of one dyadic roi with
     integer gradients.
3. main path, predict: full-width legacy VGG16 predict (21 classes, seeded
   random weights, the 800x1344 canvas, batch 1) through the port's
   ``engine.evaluate.evaluate`` on synthetic in-memory VOC batches, in
   float32 (TF32 off) and bfloat16, with the kernels' launch counts reset
   just before and read just after; the IoU kernel never runs.
4. predict vs plain: the same float32 predict with RoIPool forced to the
   plain version must give identical detections.
5. small-input predict reference: GPU float32 predict against the CPU plain
   path on a 128x192 canvas, greedy-matched (label, IoU >= 0.99, 99%
   matched, score and box |d| <= 1e-4).
6. main path, train: 20 steps of the legacy train step (800x1344, batch 2,
   gt padded to 100 slots) on one repeated synthetic batch through
   ``engine.train.train_one_epoch`` and ``parallel.train_step``, in
   float32 and under bfloat16 autocast, counts reset just before and read
   just after: the backward kernel runs once per step, the IoU kernel
   never, every loss is finite and the mean loss of steps 16-20 is below
   that of steps 1-5.
7. train step vs plain: one float32 step from the same weights and noise
   through the kernels and through plain RoIPool: identical losses;
   parameter gradients within 1e-5 * max|g| per tensor for the RPN and the
   head, 2e-4 for the backbone convs, whose gradients sum the reordered
   atomics of the RoIPool backward over the whole map (the run-to-run
   spread of two kernel runs is printed beside it).
8. small-input train reference: one GPU float32 step against the CPU
   plain path at 192x256 on the same weights, noise and targets: losses
   within relative 1e-4, gradients within 1e-2 relative L2 per tensor
   (max|d| / max|g| is printed). A max-pool window whose top two values
   lie within float32 rounding, or a ReLU input within rounding of 0,
   routes a gradient differently on the two devices, and one such flip
   moves a whole row or window of a weight gradient: one pool-1 window
   moves conv1's gradient by about 2e-3 relative L2 at this input.
9. main path, FPN predict: full-width ResNet50-FPN predict (91 classes,
   seeded random weights, the 800x1344 canvas, batch 2, 8 images) through
   ``engine.evaluate.evaluate`` with ``data_type="coco"`` and a synthetic
   ``CocoIndex`` written under ``build/``, in float32 (TF32 off) and
   bfloat16, counts reset just before and read just after: the align
   kernel runs once per predict call, RoIPool and IoU never; every image has a
   detection; the std of P2..P6 is printed.
10. FPN predict vs plain: the same float32 predict with the plain align
   must give identical detections.
11. small-input FPN reference: GPU float32 FPN predict against the CPU
   plain path at 208x240, greedy-matched as in phase 5.
12. main path, FPN train: 20 steps of the ResNet50-FPN train step (91
   classes, 800x1344, batch 2, gt padded to 100 slots with 1-3 boxes per
   image under raw COCO ids, FPN_CONFIG budgets) through
   ``train_one_epoch`` and ``parallel.train_step``, in float32 and under
   bfloat16 autocast, counts reset just before and read just after: the
   align forward and backward kernels run once per step each, RoIPool and
   IoU never; every loss is finite and the mean of steps 16-20 is below that
   of steps 1-5.
13. FPN train step vs plain: one float32 step from the same weights and
   noise through the align kernels and through the plain align (forward
   and backward): identical losses; gradients within 1e-5 * max|g| per
   tensor (the backbone and FPN convs sum the reordered atomics of the
   align backward; two kernel runs' spread is printed beside it);
   ``conv1`` and ``layer1`` get no gradient,
   and after one SGD step their weights are ``p - lr * (wd * p)`` bit for
   bit as ``torch.optim.SGD`` rounds it on zero gradients.
14. small-input FPN train reference: one GPU float32 step against the CPU
   plain path at 208x240, as phase 8.
15. main path, legacy dense-scene train: phase 6 with the gt padded to
   512 slots (``--max_gt 512``, past the IoU kernel's gate of 432) and
   300-500 small boxes tiled over each image, counts reset just before and
   read just after: the IoU kernel runs once per image and step (2 per
   step), RoIPool forward and backward once per step each; losses finite
   and falling as in phase 6; img/s printed as there.
16. dense step vs plain: one float32 dense step from the same weights and
   noise through the IoU kernel and with ``plain=True``: identical RPN and
   RoI targets (rois, labels, is_pos, valid, reg targets) and losses.
17. imports: jax and flax were never imported.

Its last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex
from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate
from faster_rcnn_pytorch_tpu_torch.engine.train import BATCH_KEYS, train_one_epoch
from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (
    FPN_CONFIG,
    LEGACY_CONFIG,
    RoITargets,
    RPNTargets,
    build_model,
    draw_train_noise,
    forward_train,
    init_weights,
    predict,
    train_losses,
    train_targets,
)
from faster_rcnn_pytorch_tpu_torch.ops import boxes as boxes_mod
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as roi_align_mod
from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as roi_pool_mod
from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension
from faster_rcnn_pytorch_tpu_torch.parallel.train_step import (
    apply_gradients,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from faster_rcnn_pytorch_tpu_torch.utils.logging import StepTimer
from faster_rcnn_pytorch_tpu_torch.utils.runtime import prepare_for_inference, set_numerics

CANVAS = (800, 1344)  # canvas_buckets(800, 1333)[0]
NUM_CLASSES = 21
N_IMAGES = 8
THRESHOLD = 0.05
SEED = 0
TRAIN_BATCH = 2
TRAIN_STEPS = 20
MAX_GT = 100  # the loader's gt slots (config.max_gt)
DENSE_MAX_GT = 512  # --max_gt of a dense scene: past the IoU kernel's gate (432 for legacy)
DENSE_BOXES = (300, 501)  # real gt boxes per dense image, [low, high)
FPN_DENSE_MAX_GT = 640  # the FPN generation's gate, timed in phase 2 only
TRAIN_LR = 1e-3
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
LOG_DIR = os.path.join(BUILD, "chip_smoke_logs")
FPN_CLASSES = 91
FPN_BATCH = 2
FPN_IMAGES = 8
FPN_SMALL_CANVAS = (208, 240)  # H/16 odd: the top-down upsample is not 2x
FROZEN = ("backbone.body.conv1.", "backbone.body.layer1.")  # FPN's frozen stages
WEIGHT_DECAY = 5e-4  # make_optimizer's default
# H100 SXM peaks (NVIDIA's data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


class SyntheticImages:
    """Loader-like stand-in: ``epoch(0)`` yields the loader's batch dicts
    (``batch_size`` images each) of seeded normalised images on the padded
    canvas, with 1-3 gt boxes per image in ``records_by_id`` (labels
    ``0 .. num_classes - 2``). The images are made up front, so a timed
    pass measures predict, not the random number generator."""

    def __init__(self, n: int, canvas: tuple[int, int], seed: int, batch_size: int = 1,
                 num_classes: int = NUM_CLASSES):
        self.n, self.canvas, self.batch_size = n, canvas, batch_size
        rs = np.random.RandomState(seed)
        pixels = np.random.default_rng(seed)
        ch, cw = canvas
        self.items = []
        self.records_by_id = {}
        rows = []
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
                labels=rs.randint(0, num_classes - 1, size=k).astype(np.int32),
                difficult=np.zeros(k, bool),
            )
            self.items.append((i, (rh, rw), orig))
            image = np.zeros((ch, cw, 3), np.float32)
            image[:rh, :rw] = pixels.standard_normal((rh, rw, 3), dtype=np.float32)
            rows.append((image, (rw / cw, rh / ch), i, orig, (rh, rw)))
        self.batches = []
        for s in range(0, n, batch_size):
            image, extent, image_id, orig, resized = zip(*rows[s : s + batch_size])
            self.batches.append(
                {
                    "image": np.stack(image),
                    "extent": np.array(extent, np.float32),
                    "image_id": np.array(image_id, np.int64),
                    "orig_hw": np.array(orig, np.int32),
                    "resized_hw": np.array(resized, np.int32),
                }
            )

    def epoch(self, epoch: int = 0):
        yield from self.batches


def write_coco_index(loader: SyntheticImages, path: str) -> CocoIndex:
    """The loader's gts as a COCO annotation file (category id = label + 1,
    the FPN generation's raw ids 1..90), read back as a ``CocoIndex``."""
    images, anns = [], []
    for img_id, _, (oh, ow) in loader.items:
        images.append({"id": img_id, "file_name": f"{img_id:012d}.jpg", "width": ow, "height": oh})
        rec = loader.records_by_id[img_id]
        for (x1, y1, x2, y2), label in zip(rec.boxes.tolist(), rec.labels.tolist()):
            anns.append(
                {
                    "id": len(anns) + 1,
                    "image_id": img_id,
                    "category_id": label + 1,
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": (x2 - x1) * (y2 - y1),
                    "iscrowd": 0,
                }
            )
    cats = [{"id": c, "name": str(c)} for c in range(1, FPN_CLASSES)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return CocoIndex(path)


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) on an H100 for ``n_bytes`` of device memory
    traffic and ``n_ops`` float32 operations, and which of the two bounds."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
            cells, bin_cells = _roi_pool_footprint(rois, h, w)
            c = f.shape[1]
            n_bytes = cells * c * 4 + rois.numel() * 4 + ref.numel() * 4
            bound_ms, bound_by = _bound(n_bytes, bin_cells * c)  # one max per bin cell
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    # PyTorch has no RoIPool call (torchvision is not a dependency).
    record.update(max_abs_err=err, library_ms=None)
    return record


def _roi_pool_footprint(rois, h: int, w: int) -> tuple[int, int]:
    """Map cells (per image) that the rois' bins cover, and the sum of the
    bins' cell counts: the reads and the comparisons this run needs."""
    b, n = rois.shape[:2]
    h_lo, h_hi, w_lo, w_hi = (t.cpu() for t in roi_pool_mod.roi_bin_bounds(rois.reshape(-1, 4), 1.0, 7, h, w))
    bin_cells = int(((h_hi - h_lo)[:, :, None] * (w_hi - w_lo)[:, None, :]).sum())
    mask = torch.zeros((b, h, w), dtype=torch.bool)
    for r in range(b * n):  # the bins of one roi tile [lo_0, hi_6) on each axis
        mask[r // n, h_lo[r].min() : h_hi[r].max(), w_lo[r].min() : w_hi[r].max()] = True
    return int(mask.sum()), bin_cells


def check_roi_pool_backward_kernel(device) -> dict:
    """The backward kernel against its plain version at the train shapes."""
    h, w = CANVAS[0] // 16, CANVAS[1] // 16
    g = torch.Generator().manual_seed(SEED + 1)
    feats = torch.relu(torch.randn(TRAIN_BATCH, 512, h, w, generator=g))
    n = LEGACY_CONFIG.roi_samples
    xy = torch.rand(TRAIN_BATCH, n, 2, generator=g) * torch.tensor([w - 4.0, h - 4.0])
    wh = torch.rand(TRAIN_BATCH, n, 2, generator=g) * torch.tensor([w / 2.0, h / 2.0])
    rois = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w * 1.0, h * 1.0]))], -1)
    edge = _edge_rois(h, w)
    edge = edge[((edge >= 0) & (edge <= torch.tensor([w, h, w, h]))).all(1)]
    rois[:, : len(edge)] = edge  # the backward's rois lie inside the map
    rois = rois.to(device)
    record = {
        "name": "roi_pool_backward",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/roi_pool.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/roi_pool_kernel.py:227",
    }
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.to(device, dtype)
        _, arg = roi_pool_mod.roi_pool_cuda(f, rois, 1.0, 7, with_argmax=True)
        shape = tuple(f.shape)
        ints = torch.randint(-3, 4, arg.shape, generator=g).to(device, dtype)
        got = roi_pool_mod.roi_pool_backward_cuda(ints, arg, shape, dtype)
        torch.cuda.synchronize()
        want = roi_pool_mod.roi_pool_backward_reference(ints, arg, shape, dtype)
        _require(
            got.dtype == dtype and torch.equal(got, want),
            f"roi_pool backward != plain on integer gradients ({dtype}): "
            f"max|d| {float((got.float() - want.float()).abs().max())}",
        )
        # Normal gradients, summed in float32 (the map before the cast).
        normal = torch.randn(arg.shape, generator=g).to(device, dtype)
        got = roi_pool_mod.roi_pool_backward_cuda(normal, arg, shape, torch.float32)
        want = roi_pool_mod.roi_pool_backward_reference(normal, arg, shape, torch.float32)
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        _require(diff <= 1e-5 * scale, f"roi_pool backward ({dtype}): max|d| {diff} > 1e-5 * {scale}")
        err = max(err, diff)
        ms = _median_ms(lambda: roi_pool_mod.roi_pool_backward_cuda(normal, arg, shape, dtype))
        plain_ms = _median_ms(
            lambda: roi_pool_mod.roi_pool_backward_reference(normal, arg, shape, dtype)
        )
        name = str(dtype).removeprefix("torch.")
        print(
            f"roi_pool_backward {name} grad {tuple(normal.shape)} -> feats {shape}: bit-exact on "
            f"integer gradients, max|d| {diff:.3g} (max|ref| {scale:.3g}) on normal ones, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)",
            flush=True,
        )
        if dtype == torch.float32:
            n_bytes = normal.numel() * 4 + arg.numel() * 4 + want.numel() * 4
            bound_ms, bound_by = _bound(n_bytes, int((arg >= 0).sum()))  # one add each
            # One PyTorch call computes the same sums: scatter_add_ on the
            # plain version's prepared [B, C, h*w + 1] index.
            b, c, h2, w2 = shape
            flat_g = normal.float().transpose(1, 2).reshape(b, c, -1)
            flat_a = arg.transpose(1, 2).reshape(b, c, -1).long()
            flat_a = torch.where(flat_a >= 0, flat_a, h2 * w2)
            acc = torch.zeros((b, c, h2 * w2 + 1), device=device)
            library_ms = _median_ms(lambda: acc.scatter_add_(2, flat_a, flat_g))
            record.update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms,
            )
            print(f"  scatter_add_ on the prepared index: {library_ms:.4f} ms", flush=True)
    record["max_abs_err"] = err
    return record


def _align_rois(generator, n: int, canvas=CANVAS) -> torch.Tensor:
    """``[FPN_BATCH, n, 4]`` canvas-pixel rois: log-uniform sizes 2..800 px
    anywhere on the canvas, the first eight of each image the extremes
    (banner, pole, degenerate, clamped-level giant, whole canvas, partly
    and wholly outside)."""
    h, w = canvas
    xy = torch.rand(FPN_BATCH, n, 2, generator=generator) * torch.tensor([w - 20.0, h - 20.0]) - 10
    wh = torch.exp(torch.empty(FPN_BATCH, n, 2).uniform_(np.log(2), np.log(800), generator=generator))
    rois = torch.cat([xy, xy + wh], -1)
    rois[:, :8] = torch.tensor(
        [
            [0, 0, w, 10],
            [0, 0, 10, h],
            [5, 5, 5.2, 5.2],
            [200, 200, 3000, 3000],
            [0, 0, w, h],
            [-30, -20, 40, 50],
            [w - 50, h - 40, w + 60, h + 30],
            [-80, 100, -10, 160],
        ],
        dtype=torch.float32,
    )
    return rois


def footprint_rois(generator, n: int, canvas=CANVAS) -> torch.Tensor:
    """``[FPN_BATCH, n, 4]`` canvas-pixel rois (``n >= 96``) whose
    footprints stress the align kernels' per-roi geometry: giant rois on P5
    (also wholly outside the canvas), rois partly and wholly outside,
    degenerate rois (zero area, zero width, on the far corner), a banner
    and a pole, 64 rois sharing one cell (32 identical, 32 nearly so), then
    ``_align_rois``' random ones."""
    h, w = canvas
    edges = torch.tensor(
        [
            [200, 200, 3000, 3000],  # giant: P5, samples past the map
            [-500, -300, 2500, 1800],  # giant: P5, the map inside it
            [0, 0, w, h],  # the whole canvas
            [-2000, -2000, -1500, -1500],  # giant, wholly outside
            [-30, -20, 40, 50],  # partly outside, top left
            [w - 50, h - 40, w + 60, h + 30],  # partly outside, bottom right
            [-100, 300, 60, 500],  # partly outside, left
            [-80, 100, -10, 160],  # wholly left
            [w + 10, h + 10, w + 90, h + 70],  # wholly beyond the far corner
            [5, 5, 5, 5],  # degenerate
            [5, 5, 5.2, 5.2],
            [w, h, w, h],  # a point on the far corner
            [0, 0, 0, 0],
            [w - 1, 0, w - 1, h],  # zero width, full height
            [0, 0, w, 10],  # banner
            [0, 0, 10, h],  # pole
        ],
        dtype=torch.float32,
    )
    clump = torch.tensor([[100, 100, 103, 103]] * 32 + [[100.5, 100.5, 102, 102]] * 32, dtype=torch.float32)
    rois = _align_rois(generator, n, canvas)
    rois[:, : len(edges)] = edges
    rois[:, len(edges) : len(edges) + len(clump)] = clump
    return rois


def align_footprint_shape(rois, level, level_shapes, nonzero: bool = False) -> torch.Tensor:
    """``[B, n, 2]`` int64: each roi's footprint, the number of distinct
    rows and of distinct columns that its 14 samples' low and high cells
    touch at its level; with ``nonzero``, only cells of a nonzero weight:
    the align backward kernel's per-roi lists, one atomic add per cell
    and channel. Two cells a sample, so at most 28 each, whatever the roi."""
    b, n = rois.shape[:2]
    flat, lv = rois.reshape(b * n, 4).float(), level.reshape(b * n)
    out = torch.zeros((b * n, 2), dtype=torch.int64, device=rois.device)
    for li, ((h, w), stride) in enumerate(zip(level_shapes, roi_align_mod.STRIDES)):
        sel = torch.nonzero(lv == li).flatten()
        r = flat[sel]
        for axis, (lo_edge, hi_edge, size) in enumerate(((r[:, 1], r[:, 3], h), (r[:, 0], r[:, 2], w))):
            low, high, w_low, w_high = roi_align_mod._axis_samples(lo_edge, hi_edge, 1.0 / stride, size)
            cells = torch.cat([low.reshape(len(sel), -1), high.reshape(len(sel), -1)], 1)
            if nonzero:
                weights = torch.cat([w_low.reshape(len(sel), -1), w_high.reshape(len(sel), -1)], 1)
                cells = torch.where(weights != 0, cells, -1)
            cells = cells.sort(1).values
            fresh = torch.cat([cells[:, :1] >= 0, cells[:, 1:] != cells[:, :-1]], 1)
            out[sel, axis] = fresh.sum(1)
    return out.reshape(b, n, 2)


def _align_footprint_cells(feats, rois, level) -> int:
    """Level-map cells (per image) that some sample of some roi weighs with
    a nonzero weight: the reads this run's data needs."""
    b, n = rois.shape[:2]
    flat, lv = rois.reshape(-1, 4), level.reshape(-1)
    image = torch.arange(b, device=rois.device).repeat_interleave(n)
    cells = 0
    for li, (f, stride) in enumerate(zip(feats, roi_align_mod.STRIDES)):
        h, w = f.shape[-2:]
        sel = torch.nonzero(lv == li).flatten()
        r = flat[sel]
        ylo, yhi, wylo, wyhi = roi_align_mod._axis_samples(r[:, 1], r[:, 3], 1.0 / stride, h)
        xlo, xhi, wxlo, wxhi = roi_align_mod._axis_samples(r[:, 0], r[:, 2], 1.0 / stride, w)
        k = len(sel)
        ys, wy = torch.cat([ylo.reshape(k, -1), yhi.reshape(k, -1)], 1), torch.cat([wylo.reshape(k, -1), wyhi.reshape(k, -1)], 1)
        xs, wx = torch.cat([xlo.reshape(k, -1), xhi.reshape(k, -1)], 1), torch.cat([wxlo.reshape(k, -1), wxhi.reshape(k, -1)], 1)
        need = (wy[:, :, None] > 0) & (wx[:, None, :] > 0)
        mask = torch.zeros((b, h, w), dtype=torch.bool, device=rois.device)
        mask[
            image[sel][:, None, None].expand_as(need)[need],
            ys[:, :, None].expand_as(need)[need],
            xs[:, None, :].expand_as(need)[need],
        ] = True
        cells += int(mask.sum())
    return cells


def _align_inputs(device):
    """Seeded P2..P5 maps at the FPN predict shapes (on the CPU) and the
    predict's 1000 rois per image with their levels (on the card)."""
    h, w = CANVAS
    g = torch.Generator().manual_seed(SEED + 7)
    feats = [
        torch.randn(FPN_BATCH, 256, -(-h // s), -(-w // s), generator=g)
        for s in roi_align_mod.STRIDES
    ]
    rois = _align_rois(g, FPN_CONFIG.post_nms_test).to(device)
    return feats, rois, roi_align_mod.fpn_level_assignment(rois)


def check_roi_align_kernel(device) -> dict:
    """The MultiScaleRoIAlign kernel against its plain version at the FPN
    predict shapes, bit for bit in float32 and bfloat16."""
    feats, rois, level = _align_inputs(device)
    print(
        f"align rois per level: {torch.bincount(level.flatten(), minlength=4).tolist()}",
        flush=True,
    )
    record = {
        "name": "multiscale_roi_align_forward",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/roi_align.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/roi_window_kernel.py:137",
        "library_ms": None,  # PyTorch has no RoIAlign call
    }
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        f = [x.to(device, dtype) for x in feats]
        out = roi_align_mod.multiscale_roi_align_cuda(f, rois, level)
        torch.cuda.synchronize()
        ref = roi_align_mod.multiscale_roi_align_reference(f, rois, level)
        diff = float((out.float() - ref.float()).abs().max())
        _require(torch.equal(out, ref), f"roi_align kernel != plain ({dtype}): max|d| {diff}")
        err = max(err, diff)
        ms = _median_ms(lambda: roi_align_mod.multiscale_roi_align_cuda(f, rois, level))
        plain_ms = _median_ms(lambda: roi_align_mod.multiscale_roi_align_reference(f, rois, level))
        name = str(dtype).removeprefix("torch.")
        print(
            f"roi_align {name} levels {[tuple(x.shape) for x in f]} rois {tuple(rois.shape)}: "
            f"bit-exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)",
            flush=True,
        )
        if dtype == torch.float32:
            cells = _align_footprint_cells(f, rois, level)
            n_bytes = cells * 256 * 4 + rois.numel() * 4 + level.numel() * 4 + out.numel() * 4
            # per output: 4 samples x (4 weight products, 4 products, 3 adds),
            # 3 sample adds, 1 scale
            bound_ms, bound_by = _bound(n_bytes, 48 * out.numel())
            print(
                f"  footprint {cells} cells of {sum(x[0, 0].numel() for x in f) * FPN_BATCH} "
                f"({n_bytes / 1e6:.1f} MB moved): bound {bound_ms:.4f} ms",
                flush=True,
            )
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = err
    return record


def check_roi_align_slots_kernel(device, align_record: dict) -> dict:
    """The slot-lattice MultiScaleRoIAlign kernel against its plain version
    at the FPN predict shapes and rois of ``check_roi_align_kernel``, bit for
    bit in float32 and bfloat16, and within 1e-5 * max|ref| of the forward
    kernel's float32 result (the same function, other rounding; in bfloat16
    within one bfloat16 ulp of it more). Its bound is that kernel's: the
    same samples weigh the same cells."""
    feats, rois, level = _align_inputs(device)
    record = {
        "name": "multiscale_roi_align_slots_forward",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/roi_align_slots.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/roi_align_kernel.py:107",
        "library_ms": None,  # PyTorch has no RoIAlign call
        "bound_ms": align_record["bound_ms"],
        "bound_by": align_record["bound_by"],
    }
    slots_cuda = roi_align_mod.multiscale_roi_align_slots_cuda
    slots_plain = roi_align_mod.multiscale_roi_align_slots_reference
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        f = [x.to(device, dtype) for x in feats]
        out = slots_cuda(f, rois, level)
        torch.cuda.synchronize()
        ref = slots_plain(f, rois, level)
        diff = float((out.float() - ref.float()).abs().max())
        _require(torch.equal(out, ref), f"slots kernel != plain ({dtype}): max|d| {diff}")
        err = max(err, diff)
        other = roi_align_mod.multiscale_roi_align_cuda(f, rois, level).float()
        scale = float(other.abs().max())
        vs_other = (out.float() - other).abs()
        ulp = torch.zeros_like(other) if dtype == torch.float32 else torch.exp2(
            torch.floor(torch.log2(other.abs().clamp(min=1e-30))) - 7
        )
        _require(
            bool((vs_other <= ulp + 1e-5 * scale).all()),
            f"slots kernel vs forward kernel ({dtype}): max|d| {float(vs_other.max())}, max|ref| {scale}",
        )
        ms = _median_ms(lambda: slots_cuda(f, rois, level))
        plain_ms = _median_ms(lambda: slots_plain(f, rois, level))
        name = str(dtype).removeprefix("torch.")
        print(
            f"roi_align_slots {name} rois {tuple(rois.shape)}: bit-exact with its plain version, "
            f"max|d| {float(vs_other.max()):.3g} from the forward kernel (max|ref| {scale:.3g}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)",
            flush=True,
        )
        if dtype == torch.float32:
            record.update(ms=ms, plain_ms=plain_ms)
    record["max_abs_err"] = err
    return record


def check_align_footprint_edges(device) -> None:
    """The three align kernels at the FPN shapes on ``footprint_rois``:
    the forward and the slot kernel bit-exact with their plain versions in
    float32 and bfloat16; the backward within 1e-5 * max|ref| of the
    float32 maps and, on ``exact_align_rois`` with 64 copies of one roi in
    each image (64 blocks adding into the same cells) and integer
    gradients, bit-exact in float32 and bfloat16."""
    g = torch.Generator().manual_seed(SEED + 10)
    shapes = _align_level_shapes()
    n = 160
    feats = [torch.randn(FPN_BATCH, 256, h, w, generator=g) for h, w in shapes]
    rois = footprint_rois(g, n).to(device)
    level = roi_align_mod.fpn_level_assignment(rois)
    exact = exact_align_rois(g, n)
    exact[:, 8:72] = exact[:, :1]
    exact = exact.to(device)
    exact_level = roi_align_mod.fpn_level_assignment(exact)
    grad_shape = (FPN_BATCH, n, 256, roi_align_mod.OUTPUT_SIZE, roi_align_mod.OUTPUT_SIZE)
    forwards = (
        (roi_align_mod.multiscale_roi_align_cuda, roi_align_mod.multiscale_roi_align_reference),
        (roi_align_mod.multiscale_roi_align_slots_cuda, roi_align_mod.multiscale_roi_align_slots_reference),
    )
    for dtype in (torch.float32, torch.bfloat16):
        f = [x.to(device, dtype) for x in feats]
        for kernel, plain in forwards:
            out = kernel(f, rois, level)
            torch.cuda.synchronize()
            ref = plain(f, rois, level)
            diff = float((out.float() - ref.float()).abs().max())
            _require(torch.equal(out, ref), f"{kernel.__name__} != plain on the edge rois ({dtype}): max|d| {diff}")
        ints = torch.randint(-3, 4, grad_shape, generator=g).to(device, dtype)
        got = roi_align_mod.multiscale_roi_align_backward_cuda(ints, exact, exact_level, shapes, dtype)
        torch.cuda.synchronize()
        want = roi_align_mod.multiscale_roi_align_backward_reference(ints, exact, exact_level, shapes, dtype)
        _require(
            all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(got, want)),
            f"align backward != plain on the clumped exact set ({dtype})",
        )
        normal = torch.randn(grad_shape, generator=g).to(device, dtype)
        got = roi_align_mod.multiscale_roi_align_backward_cuda(normal, rois, level, shapes, torch.float32)
        want = roi_align_mod.multiscale_roi_align_backward_reference(normal, rois, level, shapes, torch.float32)
        diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        _require(diff <= 1e-5 * scale, f"align backward on the edge rois ({dtype}): max|d| {diff} > 1e-5 * {scale}")
        print(
            f"align edge rois {str(dtype).removeprefix('torch.')} (levels "
            f"{torch.bincount(level.flatten(), minlength=4).tolist()}): forward and slot kernels "
            f"bit-exact, backward bit-exact on 64 rois sharing cells, max|d| {diff:.3g} "
            f"(max|ref| {scale:.3g}) on normal gradients",
            flush=True,
        )


def _require_slots_idle(phase: str) -> None:
    """No main path runs the slot-lattice align kernel (the FPN head runs
    roi_align.cu): its count, set to 0 after its kernel check and never
    reset, must still be 0 after each main-path phase."""
    n = roi_align_mod.multiscale_roi_align_slots_cuda.launches
    _require(n == 0, f"{phase} launched the slot-lattice align kernel {n} times")


def iou_boxes(generator, n_props: int, max_gt: int, n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``frcnn_targets``' IoU operands in canvas-[0, 1] coordinates: ``gt
    [max_gt, 4]`` with ``n_real`` small boxes and zero (padded) rows after
    them, and ``cand [n_props + max_gt, 4]``: proposals jittered around the
    gt, random ones, degenerate and coincident ones, then the gt appended
    (so padded rows meet padded rows: zero-area pairs)."""
    xy = torch.rand(n_real, 2, generator=generator) * 0.9
    wh = 0.01 + torch.rand(n_real, 2, generator=generator) * 0.09
    gt = torch.zeros(max_gt, 4)
    gt[:n_real] = torch.cat([xy, xy + wh], 1)
    src = gt[torch.randint(0, n_real, (n_props,), generator=generator)]
    size = (src[:, 2:] - src[:, :2]).repeat(1, 2)
    props = src + (torch.rand(n_props, 4, generator=generator) - 0.5) * 0.6 * size
    k = n_props // 8
    props[:k] = torch.rand(k, 4, generator=generator).sort(1).values[:, [0, 2, 1, 3]]  # random
    props[k : 2 * k, 2] = props[k : 2 * k, 0]  # degenerate: zero width
    props[2 * k : 3 * k] = gt[torch.randint(0, n_real, (k,), generator=generator)]  # coincident
    return torch.cat([props, gt]), gt


def check_iou_kernel(device) -> dict:
    """The IoU kernel against its plain version at the dense train shapes
    (legacy at --max_gt 512, FPN at 640), bit for bit at eps 1e-5 and at
    eps 0, where padded rows meet padded rows and the 1e-12 union floor
    decides."""
    g = torch.Generator().manual_seed(SEED + 9)
    record = {
        "name": "pairwise_iou",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/iou.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/iou_kernel.py:25",
        "library_ms": None,  # PyTorch has no IoU call (torchvision is not a dependency)
    }
    err = 0.0
    shapes = (
        ("legacy", LEGACY_CONFIG.post_nms_train, DENSE_MAX_GT),
        ("fpn", FPN_CONFIG.post_nms_train, FPN_DENSE_MAX_GT),
    )
    for generation, n_props, max_gt in shapes:
        cand, gt = (t.to(device) for t in iou_boxes(g, n_props, max_gt, 400))
        n, m = cand.shape[0], gt.shape[0]
        _require(n * m >= boxes_mod.IOU_KERNEL_MIN_PAIRS, f"{n} x {m} is below the kernel's gate")
        for eps in (1e-5, 0.0):
            got = boxes_mod.pairwise_iou_cuda(cand, gt, eps)
            torch.cuda.synchronize()
            want = boxes_mod.pairwise_iou_reference(cand, gt, eps)
            diff = float((got - want).abs().max())
            _require(
                got.dtype == torch.float32 and torch.equal(got, want),
                f"iou kernel != plain ({generation}, eps {eps}): max|d| {diff}",
            )
            err = max(err, diff)
            floored = int(((cand[:, None, 2] == cand[:, None, 0]) & (gt[None, :, 2] == gt[None, :, 0])).sum())
            ms = _median_ms(lambda: boxes_mod.pairwise_iou_cuda(cand, gt, eps))
            plain_ms = _median_ms(lambda: boxes_mod.pairwise_iou_reference(cand, gt, eps))
            print(
                f"iou {generation} [{n}, 4] x [{m}, 4] eps {eps}: bit-exact ({floored} zero-width "
                f"pairs), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)",
                flush=True,
            )
            if generation == "legacy" and eps:
                n_bytes = n * m * 4 + (n + m) * 16
                # per pair: 4 min/max, 2 subs, 2 clamps, inter, 2 adds, 1 sub, 1 div
                bound_ms, bound_by = _bound(n_bytes, 13 * n * m)
                print(f"  {n_bytes / 1e6:.2f} MB moved: bound {bound_ms:.5f} ms", flush=True)
                record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    record["max_abs_err"] = err
    return record


def exact_align_rois(generator, n: int, canvas=CANVAS) -> torch.Tensor:
    """``[FPN_BATCH, n, 4]`` canvas-pixel rois on which the align's
    adjoint is exact in any order of addition: each starts on a cell edge
    of its level and spans a whole multiple of 7 cells there (1-8 cells a
    bin), so every sample sits on a quarter cell and every corner weight
    is a multiple of 1/16. Some start up to 4 cells outside the canvas or
    end beyond it."""
    h, w = canvas
    m = 64 * n * FPN_BATCH
    lvl = torch.randint(0, len(roi_align_mod.STRIDES), (m,), generator=generator)
    stride = (4 * 2**lvl).float()[:, None]
    cells = torch.tensor([w, h]) / stride + 8
    start = ((torch.rand(m, 2, generator=generator) * cells).floor() - 4) * stride
    extent = 7 * torch.randint(1, 9, (m, 2), generator=generator).float() * stride
    rois = torch.cat([start, start + extent], 1)
    rois = rois[roi_align_mod.fpn_level_assignment(rois) == lvl][: FPN_BATCH * n]
    _require(len(rois) == FPN_BATCH * n, f"only {len(rois)} exact rois")
    return rois.reshape(FPN_BATCH, n, 4)


def _align_level_shapes(canvas=CANVAS) -> list[tuple[int, int]]:
    return [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in roi_align_mod.STRIDES]


def check_roi_align_backward_kernel(device) -> dict:
    """The MultiScaleRoIAlign backward kernel against its plain version at
    the FPN train shapes."""
    g = torch.Generator().manual_seed(SEED + 8)
    shapes = _align_level_shapes()
    n = FPN_CONFIG.roi_samples + 8  # 512 rois plus the extremes
    rois = _align_rois(g, n).to(device)
    exact = exact_align_rois(g, n).to(device)
    level = roi_align_mod.fpn_level_assignment(rois)
    exact_level = roi_align_mod.fpn_level_assignment(exact)
    print(
        f"align backward rois per level: {torch.bincount(level.flatten(), minlength=4).tolist()}, "
        f"exact set {torch.bincount(exact_level.flatten(), minlength=4).tolist()}",
        flush=True,
    )
    record = {
        "name": "multiscale_roi_align_backward",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/roi_align.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/roi_window_kernel.py:231",
    }
    grad_shape = (FPN_BATCH, n, 256, roi_align_mod.OUTPUT_SIZE, roi_align_mod.OUTPUT_SIZE)
    bwd_cuda = roi_align_mod.multiscale_roi_align_backward_cuda
    bwd_plain = roi_align_mod.multiscale_roi_align_backward_reference
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        ints = torch.randint(-3, 4, grad_shape, generator=g).to(device, dtype)
        got = bwd_cuda(ints, exact, exact_level, shapes, dtype)
        torch.cuda.synchronize()
        want = bwd_plain(ints, exact, exact_level, shapes, dtype)
        _require(
            all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(got, want)),
            f"align backward != plain on the exact set ({dtype}): max|d| "
            f"{max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))}",
        )
        # Normal gradients, summed in float32 (the maps before the cast).
        normal = torch.randn(grad_shape, generator=g).to(device, dtype)
        got = bwd_cuda(normal, rois, level, shapes, torch.float32)
        want = bwd_plain(normal, rois, level, shapes, torch.float32)
        diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        _require(diff <= 1e-5 * scale, f"align backward ({dtype}): max|d| {diff} > 1e-5 * {scale}")
        err = max(err, diff)
        ms = _median_ms(lambda: bwd_cuda(normal, rois, level, shapes, dtype))
        plain_ms = _median_ms(lambda: bwd_plain(normal, rois, level, shapes, dtype))
        name = str(dtype).removeprefix("torch.")
        print(
            f"roi_align_backward {name} grad {tuple(normal.shape)} -> levels {shapes}: bit-exact on "
            f"the exact set, max|d| {diff:.3g} (max|ref| {scale:.3g}) on normal gradients, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)",
            flush=True,
        )
        if dtype == torch.float32:
            maps_bytes = sum(FPN_BATCH * 256 * h * w * 4 for h, w in shapes)
            n_bytes = normal.numel() * 4 + rois.numel() * 4 + level.numel() * 4 + maps_bytes
            # per upstream element: the 0.25 scale, then 16 corners of a
            # weight product, a value product and an add
            bound_ms, bound_by = _bound(n_bytes, 49 * normal.numel())
            library_ms = _align_backward_library_ms(normal, rois, level, shapes)
            kept = align_footprint_shape(rois, level, shapes, nonzero=True).prod(-1).sum()
            print(
                f"  {n_bytes / 1e6:.1f} MB moved: bound {bound_ms:.4f} ms; index_put_(accumulate) "
                f"on the prepared terms: {library_ms:.4f} ms; {int(kept) * 256} atomic adds a call "
                f"(one per footprint cell of nonzero weight and channel)",
                flush=True,
            )
            record.update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms
            )
    record["max_abs_err"] = err
    return record


def _align_backward_library_ms(grad, rois, level, shapes) -> float:
    """One ``index_put_(accumulate=True)`` of every term of the plain
    version (all rois, all levels, rows offset into one NHWC buffer of the
    four maps): the same sums in one PyTorch call."""
    b, n, c = grad.shape[:3]
    flat_g = grad.reshape(b * n, c, 7, 7).float()
    flat_rois, flat_level = rois.reshape(b * n, 4), level.reshape(b * n)
    image = torch.arange(b, device=rois.device).repeat_interleave(n)
    rows, vals, base = [], [], 0
    for li, ((h, w), stride) in enumerate(zip(shapes, roi_align_mod.STRIDES)):
        sel = torch.nonzero(flat_level == li).flatten()
        r, v = roi_align_mod.backward_scatter_terms(
            flat_g[sel], flat_rois[sel], image[sel], stride, h, w
        )
        rows.append(r + base)
        vals.append(v)
        base += b * h * w
    rows, vals = torch.cat(rows), torch.cat(vals)
    acc = torch.zeros((base, c), device=rois.device)
    ms = _median_ms(lambda: acc.index_put_((rows,), vals, accumulate=True))
    del rows, vals, acc
    return ms


def synthetic_train_batch(
    canvas,
    seed: int,
    batch: int = TRAIN_BATCH,
    labels: tuple[int, int] = (0, NUM_CLASSES - 1),
    max_gt: int = MAX_GT,
    boxes: tuple[int, int] = (1, 4),
) -> dict:
    """The JAX loader's train batch layout: normalised images on the
    padded canvas (zeros past each image's extent), ``extent``, and
    ``boxes[0] .. boxes[1] - 1`` gt boxes per image padded to ``max_gt``
    slots, labels drawn from ``[labels[0], labels[1])`` (VOC's 0-based, or
    raw COCO ids 1..90 for the FPN generation). A few boxes are large and
    anywhere; more than 3 (a dense scene: a shelf, a crowd) are small
    boxes tiled over the image extent, one per cell of a grid."""
    rs = np.random.RandomState(seed)
    ch, cw = canvas
    images = np.zeros((batch, ch, cw, 3), np.float32)
    extents = np.zeros((batch, 2), np.float32)
    gt_boxes = np.zeros((batch, max_gt, 4), np.float32)
    gt_labels = np.zeros((batch, max_gt), np.int32)
    gt_mask = np.zeros((batch, max_gt), bool)
    for i in range(batch):
        rh = ch if i % 2 == 0 else int(ch * 0.75)
        rw = int(cw * (0.9 - 0.1 * (i % 3)))
        images[i, :rh, :rw] = rs.standard_normal((rh, rw, 3)).astype(np.float32)
        extents[i] = (rw / cw, rh / ch)
        k = rs.randint(*boxes)
        if boxes[1] <= 4:
            xy = rs.uniform(0.05, 0.5, size=(k, 2)) * extents[i]
            wh = rs.uniform(0.15, 0.45, size=(k, 2)) * extents[i]
        else:
            cols = int(np.ceil(np.sqrt(k * rw / rh)))
            rows = -(-k // cols)
            cell = extents[i] / (cols, rows)
            slots = np.sort(rs.choice(cols * rows, size=k, replace=False))
            origin = np.stack([slots % cols, slots // cols], 1) * cell
            xy = origin + rs.uniform(0.05, 0.25, size=(k, 2)) * cell
            wh = rs.uniform(0.5, 0.7, size=(k, 2)) * cell
        gt_boxes[i, :k] = np.concatenate([xy, np.minimum(xy + wh, extents[i])], 1)
        gt_labels[i, :k] = rs.randint(*labels, size=k)
        gt_mask[i, :k] = True
    return dict(zip(BATCH_KEYS, (images, extents, gt_boxes, gt_labels, gt_mask)))


class RepeatedBatch:
    """Loader-like stand-in: ``epoch(e)`` yields one batch ``steps`` times."""

    def __init__(self, batch: dict, steps: int):
        self.batch, self.steps = batch, steps

    def __len__(self):
        return self.steps

    def epoch(self, epoch: int = 0):
        for _ in range(self.steps):
            yield self.batch


class LossRecorder:
    """Scalar sink for ``train_one_epoch`` that keeps the step losses."""

    def __init__(self):
        self.losses: list[float] = []

    def scalar(self, tag: str, value: float, step: int) -> None:
        if tag == "train/loss":
            self.losses.append(value)


def _head_kernels(generation: str):
    """The forward and backward kernel wrappers of a generation's RoI head."""
    if generation == "legacy":
        return roi_pool_mod.roi_pool_cuda, roi_pool_mod.roi_pool_backward_cuda
    return roi_align_mod.multiscale_roi_align_cuda, roi_align_mod.multiscale_roi_align_backward_cuda


def _train_setup(generation: str):
    """The generation's config and its gt label range (VOC's 0-based
    labels for legacy, raw COCO ids 1..90 for FPN)."""
    if generation == "legacy":
        return LEGACY_CONFIG, (0, NUM_CLASSES - 1)
    return FPN_CONFIG, (1, FPN_CLASSES)


def run_train(
    dtype_name: str, device, generation: str = "legacy", dense: bool = False
) -> tuple[int, int, int]:
    """20 full-width train steps through ``train_one_epoch``; returns the
    launch counts of the generation's head kernels (forward, backward) and
    of the IoU kernel in the run, and requires the other generation's
    kernels to stay idle. ``dense``: gt padded to ``DENSE_MAX_GT`` slots
    with ``DENSE_BOXES`` boxes per image, past the IoU kernel's gate, so
    it runs once per image and step; otherwise (100 slots) never."""
    dtype = set_numerics(dtype_name)
    cfg, labels = _train_setup(generation)
    model = _new_model(generation).to(device)
    state = init_train_state(model, make_optimizer(model))
    schedule = make_lr_schedule("constant", TRAIN_LR, 1, TRAIN_STEPS)
    step_fn = make_train_step(cfg, schedule, autocast_dtype=dtype if dtype != torch.float32 else None)
    timer = StepTimer()

    def timed_step(state, batch, generator):
        timer.start()
        metrics = step_fn(state, batch, generator)
        torch.cuda.synchronize()
        timer.stop()
        return metrics

    seed = SEED + (4 if generation == "legacy" else 6) + (10 if dense else 0)
    gt = dict(max_gt=DENSE_MAX_GT, boxes=DENSE_BOXES) if dense else {}
    loader = RepeatedBatch(synthetic_train_batch(CANVAS, seed, labels=labels, **gt), TRAIN_STEPS)
    recorder = LossRecorder()
    name = f"{generation}{' dense' if dense else ''} {dtype_name}"
    opts = SimpleNamespace(
        seed=SEED, vis_step=1, log_dir=LOG_DIR, name=f"train_{name.replace(' ', '_')}",
        keep_checkpoints=1,
    )
    kernels = (*_head_kernels("legacy"), *_head_kernels("fpn"), boxes_mod.pairwise_iou_cuda)
    for k in kernels:
        k.launches = 0
    train_one_epoch(state, timed_step, loader, 0, opts, schedule, recorder)
    counts = {k.__name__: k.launches for k in kernels}
    shutil.rmtree(LOG_DIR)
    fwd, bwd = (counts.pop(k.__name__) for k in _head_kernels(generation))
    iou = counts.pop(boxes_mod.pairwise_iou_cuda.__name__)
    losses = recorder.losses
    _require(len(losses) == TRAIN_STEPS, f"{len(losses)} of {TRAIN_STEPS} losses logged")
    _require(bool(np.isfinite(losses).all()), f"{name} train: non-finite loss {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    _require(last < first, f"{name} train: loss did not fall ({first} -> {last})")
    _require(bwd == TRAIN_STEPS, f"{name} train: {bwd} backward launches, want {TRAIN_STEPS}")
    _require(fwd == TRAIN_STEPS, f"{name} train: {fwd} forward launches, want {TRAIN_STEPS}")
    want_iou = TRAIN_STEPS * TRAIN_BATCH if dense else 0
    _require(iou == want_iou, f"{name} train: {iou} IoU launches, want {want_iou}")
    _require(not any(counts.values()), f"{name} train launched another head's kernels: {counts}")
    _require_slots_idle(f"{name} train")
    steady = timer.times[5:]
    print(
        f"train {name} {CANVAS[0]}x{CANVAS[1]} batch {TRAIN_BATCH}"
        f"{f' gt slots {DENSE_MAX_GT}' if dense else ''}: "
        f"{TRAIN_BATCH * len(steady) / sum(steady):.2f} img/s over steps 6-{TRAIN_STEPS} "
        f"(step p50 {1000 * timer.p50():.1f} ms), mean loss steps 1-5 {first:.4f} -> "
        f"16-20 {last:.4f}, launches fwd {fwd} bwd {bwd} iou {iou}, other kernels {counts}",
        flush=True,
    )
    return fwd, bwd, iou


def check_dense_targets_kernel_vs_plain(device) -> None:
    """One float32 legacy dense-scene step from the same weights and noise
    through the IoU kernel and through ``plain=True``: identical RPN and
    RoI targets (rois, labels, is_pos, valid, reg targets), two kernel
    launches against none, and identical losses."""
    set_numerics("float32")
    cfg = LEGACY_CONFIG
    model = _new_model("legacy").to(device)
    batch = _to_device(
        synthetic_train_batch(CANVAS, SEED + 12, max_gt=DENSE_MAX_GT, boxes=DENSE_BOXES), device
    )
    anchors = torch.from_numpy(model.canvas_anchors(*CANVAS)).to(device)
    noise = draw_train_noise(
        torch.Generator(device=device).manual_seed(SEED), TRAIN_BATCH, anchors.shape[0],
        cfg.post_nms_train + DENSE_MAX_GT, device,
    )
    iou_k = boxes_mod.pairwise_iou_cuda
    with torch.no_grad():
        feats = model.features(batch["image"].permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
    targets = []
    for plain in (False, True):
        before = iou_k.launches
        targets.append(
            train_targets(
                cfg, anchors, rpn_cls, rpn_reg, *(batch[k] for k in BATCH_KEYS[1:]), noise, plain=plain
            )
        )
        torch.cuda.synchronize()
        want = before if plain else before + TRAIN_BATCH
        _require(iou_k.launches == want, f"IoU launches {before} -> {iou_k.launches} (plain={plain})")
    (k_rpn, k_roi), (p_rpn, p_roi) = targets
    for field in RoITargets._fields:
        _require(torch.equal(getattr(k_roi, field), getattr(p_roi, field)), f"RoI targets differ in {field}")
    for field in RPNTargets._fields:
        _require(torch.equal(getattr(k_rpn, field), getattr(p_rpn, field)), f"RPN targets differ in {field}")
    losses = []
    for plain in (False, True):
        before = iou_k.launches
        out = forward_train(model, cfg, *(batch[k] for k in BATCH_KEYS), noise=noise, plain=plain)
        torch.cuda.synchronize()
        _require(iou_k.launches == before + (0 if plain else TRAIN_BATCH), "forward_train IoU launches")
        losses.append(_loss_vector(out))
    _require(torch.equal(*losses), f"dense losses differ: {losses[0].tolist()} vs {losses[1].tolist()}")
    n_real = batch["gt_mask"].sum(1).tolist()
    print(
        f"dense train step legacy float32 ({n_real} of {DENSE_MAX_GT} gt slots real): RoI and RPN "
        f"targets identical with the IoU kernel and with the plain IoU ({int(k_roi.is_pos.sum())} "
        f"positive rois), losses identical ({', '.join(f'{v:.5f}' for v in losses[0].tolist())})",
        flush=True,
    )


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}


def _grads(model) -> dict:
    """Each parameter's gradient, or None where the loss does not reach it."""
    return {
        n: None if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()
    }


def _loss_vector(out) -> torch.Tensor:
    return torch.stack([t.detach() for t in out.losses])


def _grad_rel_errors(got: dict, want: dict) -> dict:
    """max|d| / max|g| per tensor; a parameter without a gradient must
    have none on both sides."""
    for n, g in want.items():
        _require((g is None) == (got[n] is None), f"{n}: a gradient on one side only")
    return {
        n: float((got[n] - g).abs().max() / g.abs().max()) for n, g in want.items() if g is not None
    }


def check_train_step_kernel_vs_plain(device, generation: str = "legacy") -> None:
    """One float32 step through the kernels, through the plain head ops
    (forward and backward), and through the kernels again (the run-to-run
    spread of the atomics). For FPN, the frozen stages then take one SGD
    step of weight decay alone."""
    set_numerics("float32")
    cfg, labels = _train_setup(generation)
    model = _new_model(generation).to(device)
    batch = _to_device(synthetic_train_batch(CANVAS, SEED + 2, labels=labels), device)
    n_anchors = model.canvas_anchors(*CANVAS).shape[0]
    noise = draw_train_noise(
        torch.Generator(device=device).manual_seed(SEED),
        TRAIN_BATCH,
        n_anchors,
        cfg.post_nms_train + MAX_GT,
        device,
    )
    fwd_k, bwd_k = _head_kernels(generation)
    runs = []
    for plain in (False, True, False):
        model.zero_grad(set_to_none=True)
        before = (fwd_k.launches, bwd_k.launches)
        out = forward_train(model, cfg, *(batch[k] for k in BATCH_KEYS), noise=noise, plain=plain)
        out.losses.total.backward()
        torch.cuda.synchronize()
        after = (fwd_k.launches, bwd_k.launches)
        want = before if plain else (before[0] + 1, before[1] + 1)
        _require(after == want, f"launches {before} -> {after} (plain={plain})")
        runs.append((_loss_vector(out), _grads(model)))
    (k_loss, k_grads), (p_loss, p_grads), (_, k2_grads) = runs
    _require(torch.equal(k_loss, p_loss), f"losses differ: {k_loss.tolist()} vs {p_loss.tolist()}")
    vs_plain = _grad_rel_errors(k_grads, p_grads)
    vs_kernel = _grad_rel_errors(k2_grads, k_grads)
    # Only the backbone convs (and FPN's pyramid convs) see the head's
    # features-gradient, whose float32 sums the atomics reorder; their
    # weight gradients sum that over every position of the maps. VGG's
    # conv1 sums 1M positions of a full-resolution map and moves most; FPN
    # freezes its stem and layer1, and its trainable convs stay near 1e-6.
    # The RPN and the head see none of it.
    for name, rel in vs_plain.items():
        tol = 2e-4 if name.startswith("extractor.") else 1e-5
        _require(rel <= tol, f"{name}: max|d| / max|g| = {rel} > {tol} (kernel vs plain)")
    print(
        f"train step {generation} float32 {CANVAS[0]}x{CANVAS[1]}: losses identical with the "
        f"kernels and with the plain head ops ({', '.join(f'{v:.5f}' for v in k_loss.tolist())})",
        flush=True,
    )
    for label, errs in (("kernel vs plain", vs_plain), ("kernel vs kernel", vs_kernel)):
        print(
            f"  max|d| / max|g| {label}: "
            + " ".join(f"{n.removesuffix('.weight')}={e:.2g}" for n, e in errs.items() if n.endswith("weight")),
            flush=True,
        )
    if generation == "fpn":
        check_frozen_stages_decay(model, k2_grads)


def check_frozen_stages_decay(model, grads: dict) -> None:
    """``conv1`` and ``layer1`` get no gradient from the loss; one
    ``apply_gradients`` step (lr ``TRAIN_LR``, momentum 0.9, weight decay
    ``WEIGHT_DECAY``) must move them exactly as ``torch.optim.SGD`` moves
    the same weights on zero gradients, ``p - lr * (wd * p)``."""
    frozen = [n for n in grads if n.startswith(FROZEN)]
    _require(len(frozen) == 11 and all(grads[n] is None for n in frozen), f"frozen grads {frozen}")
    _require(all(g is not None for n, g in grads.items() if n not in frozen), "a trainable grad is None")
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in frozen}
    state = init_train_state(model, make_optimizer(model, weight_decay=WEIGHT_DECAY))
    apply_gradients(state, make_lr_schedule("constant", TRAIN_LR, 1, 1))
    twins = [before[n].clone() for n in frozen]
    for t in twins:
        t.grad = torch.zeros_like(t)
    torch.optim.SGD(twins, lr=TRAIN_LR, momentum=0.9, weight_decay=WEIGHT_DECAY).step()
    worst = 0.0
    for n, twin in zip(frozen, twins):
        p, p0 = params[n].detach(), before[n]
        _require(torch.equal(p, twin), f"{n}: the step differs from SGD's on a zero gradient")
        formula = p0 - TRAIN_LR * (WEIGHT_DECAY * p0)
        worst = max(worst, float(((p - formula).abs() / p0.abs().clamp(min=1e-30)).max()))
    _require(worst <= 2.0**-22, f"frozen stages: relative {worst} from p - lr * (wd * p)")
    print(
        f"  frozen stages ({len(frozen)} tensors): no gradient; one SGD step equals SGD on zero "
        f"gradients bit for bit, within {worst:.3g} relative of p - lr * (wd * p)",
        flush=True,
    )


def check_small_input_train_reference(device, generation: str = "legacy", canvas=(192, 256)) -> None:
    """One GPU float32 train step against the CPU plain path on a small
    canvas, on the same weights, noise and targets (targets from the CPU
    side's RPN outputs: near-tied proposal scores could otherwise sort
    apart)."""
    cfg, labels = _train_setup(generation)
    set_numerics("float32")
    batch = synthetic_train_batch(canvas, SEED + 3, labels=labels)
    cpu_model, gpu_model = _new_model(generation), _new_model(generation).to(device)
    anchors = torch.from_numpy(cpu_model.canvas_anchors(*canvas))
    noise = draw_train_noise(
        torch.Generator().manual_seed(SEED), TRAIN_BATCH, anchors.shape[0],
        cfg.post_nms_train + MAX_GT, "cpu",
    )
    results = []
    targets = None
    for model, dev in ((cpu_model, torch.device("cpu")), (gpu_model, device)):
        b = _to_device(batch, dev)
        feats = model.features(b["image"].permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
        if targets is None:
            targets = train_targets(
                cfg, anchors, rpn_cls, rpn_reg, *(b[k] for k in BATCH_KEYS[1:]), noise
            )
        rpn_tg = RPNTargets(*(t.to(dev) for t in targets[0]))
        roi_tg = RoITargets(*(t.to(dev) for t in targets[1]))
        out = train_losses(model, cfg, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, canvas)
        out.losses.total.backward()
        grads = {n: None if g is None else g.cpu() for n, g in _grads(model).items()}
        results.append((_loss_vector(out).cpu(), grads))
    (c_loss, c_grads), (g_loss, g_grads) = results
    rel_loss = float(((g_loss - c_loss).abs() / c_loss.abs().clamp(min=1e-12)).max())
    _require(rel_loss <= 1e-4, f"small-input train: losses {g_loss.tolist()} vs {c_loss.tolist()}")
    _grad_rel_errors(g_grads, c_grads)  # the same parameters without a gradient
    worst_max, worst_l2 = 0.0, 0.0
    for name, want in c_grads.items():
        if want is None:
            continue
        d = g_grads[name] - want
        rel = float(d.norm() / want.norm())
        _require(rel <= 1e-2, f"small-input train {name}: relative L2 {rel} > 1e-2")
        worst_l2 = max(worst_l2, rel)
        worst_max = max(worst_max, float(d.abs().max() / want.abs().max()))
    print(
        f"small input train {generation} {canvas}: GPU vs CPU plain path, losses within "
        f"{rel_loss:.3g} relative, gradients within {worst_l2:.3g} relative L2 (max|d| / max|g| "
        f"{worst_max:.3g})",
        flush=True,
    )


def _detections_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[i][k], b[i][k]) for i in a for k in ("boxes", "labels", "scores")
    )


def _require(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _check_outputs(result: dict, loader: SyntheticImages, labels: tuple[int, int]) -> list[int]:
    """Shapes, ranges and finiteness of an eval pass's detections; returns
    the detection count of each image. ``labels`` is the dataset's id range."""
    counts = []
    for img_id, det in result["detections"].items():
        _, (rh, rw), (oh, ow) = loader.items[img_id]
        ch, cw = loader.canvas
        boxes, lab, scores = det["boxes"], det["labels"], det["scores"]
        _require(boxes.ndim == 2 and boxes.shape[1] == 4, f"boxes {boxes.shape}")
        _require(np.isfinite(boxes).all() and np.isfinite(scores).all(), "non-finite output")
        # boxes are clamped to the canvas, in original-image pixels
        _require(
            (boxes >= 0).all()
            and (boxes[:, [0, 2]] <= cw * ow / rw * 1.0001).all()
            and (boxes[:, [1, 3]] <= ch * oh / rh * 1.0001).all(),
            "boxes outside the canvas",
        )
        _require(((lab >= labels[0]) & (lab <= labels[1])).all(), "label out of range")
        _require(((scores > THRESHOLD) & (scores <= 1.0)).all(), "score out of range")
        counts.append(len(scores))
    _require(result["n_images"] == loader.n, f"{result['n_images']} of {loader.n} images")
    return counts


def run_predict(model, dtype_name: str, device, loader, generation="legacy", plain=False):
    """One eval pass through ``evaluate``: legacy on VOC, fpn on the
    loader's synthetic COCO index. Returns the result and the per-image
    detection counts."""
    dtype = set_numerics(dtype_name)
    model = prepare_for_inference(model, device, dtype)
    if generation == "legacy":
        cfg, kw, labels = LEGACY_CONFIG, {}, (0, NUM_CLASSES - 2)
    else:
        cfg, labels = FPN_CONFIG, (1, FPN_CLASSES - 1)
        kw = dict(data_type="coco", coco_index=loader.coco_index, label_map=lambda l: l + 1)
    result = evaluate(
        model, cfg, loader, score_threshold=THRESHOLD, plain=plain, verbose=False, **kw
    )
    counts = _check_outputs(result, loader, labels)
    print(
        f"predict {generation} {dtype_name}{' plain' if plain else ''} "
        f"{loader.canvas[0]}x{loader.canvas[1]} batch {loader.batch_size}: "
        f"{result['n_images'] / result['seconds']:.2f} img/s, {sum(counts)} detections "
        f"({min(counts)}-{max(counts)} per image), mAP = {result['map']:.4f}",
        flush=True,
    )
    return result, counts


def _new_model(generation: str = "legacy"):
    model, _ = build_model(generation, FPN_CLASSES if generation == "fpn" else NUM_CLASSES)
    return init_weights(model, torch.Generator().manual_seed(SEED))


def check_small_input_reference(device, generation="legacy", canvas=(128, 192)):
    """GPU float32 predict vs the CPU plain path on a small canvas."""
    cfg = LEGACY_CONFIG if generation == "legacy" else FPN_CONFIG
    set_numerics("float32")
    loader = SyntheticImages(2, canvas, SEED + 1, batch_size=1 if generation == "legacy" else 2)
    cpu_model = prepare_for_inference(_new_model(generation), torch.device("cpu"), torch.float32)
    gpu_model = prepare_for_inference(_new_model(generation), device, torch.float32)
    for batch in loader.epoch(0):
        images = torch.from_numpy(batch["image"])
        extents = torch.from_numpy(batch["extent"])
        want = predict(cpu_model, cfg, images, extents, THRESHOLD)
        got = predict(gpu_model, cfg, images.to(device), extents.to(device), THRESHOLD)
        for i in range(images.shape[0]):
            ok, summary = detections_agree(
                _valid(got, i), _valid(want, i), score_tol=1e-4, box_tol=1e-4
            )
            _require(ok, f"{generation} GPU vs CPU on {canvas}: {summary}")
            print(f"small input {generation} {canvas}: GPU vs CPU plain path, {summary}", flush=True)


def _valid(det, i: int = 0) -> dict:
    ok = det.valid[i].cpu().numpy()
    return {k: getattr(det, k)[i].cpu().numpy()[ok] for k in ("boxes", "labels", "scores")}


def _fpn_loader(seed: int, n: int = FPN_IMAGES) -> SyntheticImages:
    loader = SyntheticImages(n, CANVAS, seed, batch_size=FPN_BATCH, num_classes=FPN_CLASSES)
    path = os.path.join(BUILD, "chip_smoke_coco", f"instances_{seed}_{n}.json")
    loader.coco_index = write_coco_index(loader, path)
    return loader


def run_fpn_predict(device) -> tuple[int, dict]:
    """Full-width FPN predict in float32 and bfloat16, counts reset just
    before and read just after each: one align launch per predict call,
    no RoIPool launch, at least one detection per image. Returns the align
    launches of both runs and the float32 detections."""
    launches = 0
    detections = {}
    for dtype_name in ("float32", "bfloat16"):
        model = _new_model("fpn")
        # Warm-up (cuDNN and cuBLAS handles, first launches), outside the counts.
        run_predict(model, dtype_name, device, _fpn_loader(SEED + 4, FPN_BATCH), "fpn")
        loader = _fpn_loader(SEED + 5)
        roi_align_mod.multiscale_roi_align_cuda.launches = 0
        roi_pool_mod.roi_pool_cuda.launches = boxes_mod.pairwise_iou_cuda.launches = 0
        result, counts = run_predict(model, dtype_name, device, loader, "fpn")
        align = roi_align_mod.multiscale_roi_align_cuda.launches
        pool = roi_pool_mod.roi_pool_cuda.launches
        calls = len(loader.batches)
        _require(align == calls, f"{dtype_name} FPN predict: {align} align launches for {calls} calls")
        _require(pool == 0, f"{dtype_name} FPN predict launched RoIPool {pool} times")
        _require(boxes_mod.pairwise_iou_cuda.launches == 0, f"{dtype_name} FPN predict launched the IoU kernel")
        _require_slots_idle(f"{dtype_name} FPN predict")
        _require(min(counts) > 0, f"{dtype_name} FPN predict: an image without detections {counts}")
        launches += align
        with torch.no_grad():
            images = torch.from_numpy(loader.batches[0]["image"]).to(device)
            feats = model.features(images.permute(0, 3, 1, 2).to(next(model.parameters()).dtype))
        print(
            f"  P2..P6 std ({dtype_name}): "
            + " ".join(f"{float(f.float().std()):.3f}" for f in feats)
            + f"; align launches {align} for {calls} predict calls, RoIPool {pool}",
            flush=True,
        )
        if dtype_name == "float32":
            detections = result["detections"]
    return launches, detections


def main() -> int:
    t_start = time.time()
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
    # Deterministic cuDNN algorithms: phases 4, 7, 10 and 13 compare two float32 runs bit for bit.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True

    record = check_roi_pool_kernel(device)
    bwd_record = check_roi_pool_backward_kernel(device)
    align_record = check_roi_align_kernel(device)
    align_bwd_record = check_roi_align_backward_kernel(device)
    iou_record = check_iou_kernel(device)
    slots_record = check_roi_align_slots_kernel(device, align_record)
    check_align_footprint_edges(device)
    roi_align_mod.multiscale_roi_align_slots_cuda.launches = 0
    iou_kernel = boxes_mod.pairwise_iou_cuda

    launches = 0
    detections = {}
    for dtype_name in ("float32", "bfloat16"):
        model = _new_model()
        # Warm-up (cuDNN and cuBLAS handles, first launches), outside the counts.
        run_predict(model, dtype_name, device, SyntheticImages(1, CANVAS, SEED))
        loader = SyntheticImages(N_IMAGES, CANVAS, SEED)
        roi_pool_mod.roi_pool_cuda.launches = iou_kernel.launches = 0
        result, counts = run_predict(model, dtype_name, device, loader)
        count = roi_pool_mod.roi_pool_cuda.launches
        _require(count > 0, f"{dtype_name} predict never launched the RoIPool kernel")
        _require(iou_kernel.launches == 0, f"{dtype_name} predict launched the IoU kernel")
        _require_slots_idle(f"{dtype_name} predict")
        if dtype_name == "float32":
            _require(sum(counts) > 0, "float32 predict found no detections to compare")
            detections = result["detections"]
        launches += count

    roi_pool_mod.roi_pool_cuda.launches = 0
    plain, _ = run_predict(
        _new_model(), "float32", device, SyntheticImages(N_IMAGES, CANVAS, SEED), plain=True
    )
    _require(roi_pool_mod.roi_pool_cuda.launches == 0, "the plain-RoIPool run launched the kernel")
    _require(
        _detections_equal(plain["detections"], detections),
        "float32 detections differ between kernel and plain RoIPool",
    )
    print("float32 detections identical with the kernel and with plain RoIPool", flush=True)

    check_small_input_reference(device)

    bwd_launches = 0
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, _ = run_train(dtype_name, device)
        launches += fwd
        bwd_launches += bwd
    record["launches"] = launches
    bwd_record["launches"] = bwd_launches

    check_train_step_kernel_vs_plain(device)
    check_small_input_train_reference(device)

    align_record["launches"], fpn_detections = run_fpn_predict(device)
    fpn_loader = _fpn_loader(SEED + 5)
    roi_align_mod.multiscale_roi_align_cuda.launches = 0
    plain, _ = run_predict(_new_model("fpn"), "float32", device, fpn_loader, "fpn", plain=True)
    _require(
        roi_align_mod.multiscale_roi_align_cuda.launches == 0, "the plain-align run launched the kernel"
    )
    _require(
        _detections_equal(plain["detections"], fpn_detections),
        "float32 FPN detections differ between the align kernel and the plain align",
    )
    print("float32 FPN detections identical with the kernel and with the plain align", flush=True)
    check_small_input_reference(device, "fpn", FPN_SMALL_CANVAS)

    align_bwd_record["launches"] = 0
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, _ = run_train(dtype_name, device, "fpn")
        align_record["launches"] += fwd
        align_bwd_record["launches"] += bwd
    check_train_step_kernel_vs_plain(device, "fpn")
    check_small_input_train_reference(device, "fpn", FPN_SMALL_CANVAS)

    iou_record["launches"] = 0
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, iou = run_train(dtype_name, device, dense=True)
        record["launches"] += fwd
        bwd_record["launches"] += bwd
        iou_record["launches"] += iou
    check_dense_targets_kernel_vs_plain(device)
    slots_record["launches"] = roi_align_mod.multiscale_roi_align_slots_cuda.launches
    _require_slots_idle("the main paths")

    leaked = [m for m in ("jax", "flax") if m in sys.modules]
    _require(not leaked, f"imported {leaked}")

    print(f"chip_smoke: {time.time() - t_start:.1f}s end to end", flush=True)
    print(
        json.dumps(
            {
                "kernels": [
                    record, bwd_record, align_record, align_bwd_record, iou_record, slots_record
                ]
            }
        ),
        flush=True,
    )
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

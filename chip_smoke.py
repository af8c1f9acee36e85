#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, builds the port's kernels from the sources in the checkout
(into ``build/torch_kernels/``) and exits non-zero if any phase fails:

1. device: a CUDA card is present; prints its name and power limit.
2. kernels: each hand-written kernel against its plain PyTorch version,
   timed with CUDA events (median of 25 runs; the RoIPool and IoU kernels
   also back to back, 10 calls between two events, so that their wrappers'
   host path overlaps the device's work), with its bound (the least
   time for the bytes this run's data needs at 3.35 TB/s, or its
   operations at 67 TFLOP/s float32, whichever is larger):
   * RoIPool forward at the legacy predict shape (feats [1, 512, 50, 84],
     rois [1, 300, 4] plus edge rois, timed without the argmax: the
     record's times) and at the legacy train shape (feats [2, 512, 50, 84],
     128 rois per image, timed with the argmax, as train calls it);
     float32 and bfloat16; values and argmax bit-exact;
   * RoIPool backward at the legacy train shapes (feats [2, 512, 50, 84],
     128 rois per image plus edge rois inside the map, argmax from the
     forward kernel): integer-valued gradients bit-exact in float32 and
     bfloat16, normal ones within 1e-5 * max|ref| (shared-memory atomics
     add in another order); ``scatter_add_`` on the prepared index is
     timed beside it;
   * both RoIPool kernels on maps whose channel plane exceeds a block's
     shared memory ([1, 16, 240, 256] float32, [1, 16, 340, 352]
     bfloat16: the forward's direct-read route, the backward's row bands)
     and on [1, 16, 240, 256] bfloat16 (a staged forward block of 122 KB),
     64 rois with the edge rois: the forward bit-exact, the backward as
     above; then the launch plans of phase 2's RoIPool shapes;
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
     padded zero gt rows, 10 gt slots copied), eps 1e-5 and eps 0
     (zero-area pairs hit the 1e-12 union floor): the matrix mode
     bit-exact without masks, with both masks and on a width that is not a
     multiple of 4; the match mode over the two-image batch equal to the
     plain chain (max bit for bit, first argmax); both also back to back
     (``BURST`` calls), beside an empty kernel (the launch floor) and the
     per-image chain (matrix, ``where``, ``max``) that the match replaces;
   * the slot-lattice MultiScaleRoIAlign forward (no main path runs it) on
     the forward's predict shapes and rois, float32 and bfloat16: bit-exact
     with its plain version, within 1e-5 * max|ref| of the forward kernel
     (one bfloat16 ulp more in bfloat16), bound as the forward's. Its
     count is set to 0 after this check and never reset: phases 3, 6, 9,
     12 and 15 each require it still 0, and its record's ``launches`` is
     the count read after phase 20;
   * the three align kernels on rois whose footprints stress their
     per-roi geometry (``footprint_rois``: giant rois on P5, rois partly or
     wholly outside the canvas, degenerate rois, 64 rois sharing one cell):
     both forwards bit-exact in float32 and bfloat16, the backward within
     1e-5 * max|ref| and bit-exact on 64 copies of one dyadic roi with
     integer gradients;
   * the segmented NMS kernel at every call site of ``ops/nms.py``
     (``NMS_SITES``: the batch's proposals at each generation's predict and
     train budgets, the legacy offset pass, the FPN compact and per-class
     passes as 182 segments) on seeded segments with clumps, duplicates,
     tied scores, degenerate and zero-area boxes and invalid tails: keep
     and counts identical with ``nms_segments_reference``; timed one call
     and back to back beside the launch floor and the plain sweep on the
     card (what the kernel replaces), bound by the pairs the greedy tests;
     each site's cluster width (``ops/nms.py::launch_plan``) and the pairs
     the cluster design covers are printed beside the greedy's. Then the
     legacy train proposals with ``post_k`` cut inside a tile (the next
     survivor in the same tile of 64), at 8 and 16 CTAs a segment: keep and
     counts identical with the plain sweep.
3. main path, predict: full-width legacy VGG16 predict (21 classes, seeded
   random weights, the 800x1344 canvas, batch 1) through the port's
   ``engine.evaluate.evaluate`` on synthetic in-memory VOC batches, in
   float32 (TF32 off) and bfloat16, with the kernels' launch counts reset
   just before and read just after; the NMS kernel runs twice a call
   (proposals, per-class), the IoU kernel never.
4. predict vs plain: the same float32 predict with RoIPool and NMS forced
   to the plain versions must give identical detections.
5. small-input predict reference: GPU float32 predict against the CPU plain
   path on a 128x192 canvas, greedy-matched (label, IoU >= 0.99, 99%
   matched, score and box |d| <= 1e-4).
6. main path, train: 20 steps of the legacy train step (800x1344, batch 2,
   gt padded to 100 slots) on one repeated synthetic batch through
   ``engine.train.train_one_epoch`` and ``parallel.train_step``, in
   float32 and under bfloat16 autocast, counts reset just before and read
   just after: the backward kernel and the NMS kernel (the batch's
   proposals) run once per step, the IoU kernel never, every loss is
   finite and the mean loss of steps 16-20 is below that of steps 1-5.
7. train step vs plain: one float32 step from the same weights and noise
   through the kernels and through plain RoIPool and NMS: identical losses;
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
   kernel runs once per predict call and NMS twice, RoIPool and IoU never;
   every image has a detection; the std of P2..P6 is printed.
10. FPN predict vs plain: the same float32 predict with the plain align and
   NMS must give identical detections.
11. small-input FPN reference: GPU float32 FPN predict against the CPU
   plain path at 208x240, greedy-matched as in phase 5.
12. main path, FPN train: 20 steps of the ResNet50-FPN train step (91
   classes, 800x1344, batch 2, gt padded to 100 slots with 1-3 boxes per
   image under raw COCO ids, FPN_CONFIG budgets) through
   ``train_one_epoch`` and ``parallel.train_step``, in float32 and under
   bfloat16 autocast, counts reset just before and read just after: the
   align forward and backward kernels and NMS run once per step each,
   RoIPool and IoU never; every loss is finite and the mean of steps 16-20 is below that
   of steps 1-5.
13. FPN train step vs plain: one float32 step from the same weights and
   noise through the align and NMS kernels and through the plain align
   (forward and backward) and NMS: identical losses; gradients within 1e-5 * max|g| per
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
   read just after: the IoU kernel's match mode runs once per step for
   the batch and its matrix mode never, RoIPool forward and backward and
   NMS once per step each; losses finite and falling as in phase 6; img/s
   printed as there, with the run's peak ``max_memory_allocated`` and the
   stages of 6 more steps (a device sync between backbone + RPN, propose
   + targets, head + loss, backward and SGD: ``train_stage_rows``), with
   propose + targets' share of the step.
16. dense step vs plain: one float32 dense step from the same weights and
   noise through the IoU match and NMS kernels and with ``plain=True``:
   identical RPN and RoI targets (rois, labels, is_pos, valid, reg
   targets) and losses.
17. sync-free predict: full-width bfloat16 predict, legacy at batch 1 and
   FPN at batch 2, the canvas anchors already on the device, under
   ``torch.cuda.set_sync_debug_mode("error")``: it must not raise.
18. export: ``serving.export_predict`` into ``build/chip_smoke_export/``
   (legacy bfloat16 batch 1 in both buckets of ``canvas_buckets(800,
   1333)``, FPN bfloat16 batch 2 in the landscape one, one legacy artifact
   with a params sidecar); each loaded back with ``load_artifact`` gives
   packed detections bit-identical to direct predict, and its call raises
   the RoIPool or align count and the NMS count; sizes, export time and
   ms a call beside direct predict are printed.
19. serve: ``serve.InferenceServer`` over the FPN export dir
   (``batch_wait_ms`` 20) behind HTTP on ``127.0.0.1`` port 0, 16
   concurrent ``POST /detect`` of seeded JPEGs: every dispatch equals direct
   predict on its batch, every response its row through
   ``detections_to_pixels``; ``/metrics`` counts fewer dispatches than
   requests; requests/s and latency p50/p99 are printed.
20. demo: ``engine.demo.demo`` over 4 seeded JPEGs under
   ``build/chip_smoke_demo/`` (legacy bfloat16): detections equal direct
   predict at the demo's /64 bucket; FPS printed.
21. DDP at world size 1 over NCCL: a spawned process joins a one-rank
   NCCL group (``parallel/mesh.py``) and runs phases 6 and 12's train
   (the same weights, batch, LR and epoch generator) through the DDP step,
   8 steps a generation and dtype: in float32 the first step's losses
   equal the single process's bit for bit, and steps 2-3 agree within
   1e-4 relative (the backward's atomics leave the weights apart by
   rounding run to run, in one process too); bfloat16's are printed;
   img/s and step p50 over the last 5 are printed beside phases 6 and
   12's (the wrapper's cost on one card).
22. two ranks on the one card over gloo (``backend="gloo"``, named here:
   gloo's collectives take CUDA tensors, checked on this machine before
   the phase was written), both on ``cuda:0``: the legacy float32 step at
   data 2 (one image a rank) and at data 1 x model 2 (fc6/fc7 split)
   against one process's step on the two images: losses within 1e-5
   relative, gradients within phase 7's gate (2e-4 backbone, 1e-5 RPN
   and head, of max|g|; the data-2 ranks against one process taking an
   image at a time with the batch's counts, since a batch of one rounds
   otherwise than a batch of two, and their distance to the two-image
   step printed), every replica bit-identical after the step; then
   the VOC eval of 8 images at one image a rank: detections identical to
   one process's at batch 1, and the same mAP.
23. ``--remat_backbone``: legacy and FPN, float32 then bfloat16, one step
   with and without the checkpointed backbone (losses bit for bit and
   gradients within the gate in float32), then peak
   ``max_memory_allocated`` and step p50 over 5 steps each.
24. the directory backend with ``--async_checkpoint``, inside phase 21's
   NCCL process: legacy float32 steps with no save in flight, then an
   asynchronous directory save of the legacy train state (about 1.1 GB)
   and the steps taken while it is written (p50 of each printed); the
   state loaded back equals the saved one.
25. pretrained weights, offline: a ``FRT_CACHE_DIR`` of its own under
   ``build/chip_smoke_pretrained/`` (removed after) holds seeded files in
   the published layouts: torchvision's ``vgg16-397923af.pth`` (with
   ``classifier.{0,3,6}``), ``resnet50-0676ba61.pth`` (with ``fc``, no
   ``num_batches_tracked``) and a ``frcnn.best.pth.tar`` of a seeded
   legacy VOC detector (``save_torch_checkpoint``). ``--pretrained_backbone
   auto`` through ``utils.checkpoint.init_params`` (``main``'s call), both
   generations: the backbone on the card equals the file bit for bit and
   every other tensor the CLI's seeded fresh init (``init_detector_weights``,
   the JAX package's init distributions); then 3 float32 train steps
   at 800x1344, batch 2 (legacy 21 classes, FPN 91), counts reset just
   before and read just after: the head's forward and backward kernels
   and NMS once a step, losses finite. ``--checkpoint pretrained``
   through ``load_detector`` (``demo``, ``export``) and the same file by
   path through ``resolve_and_load_params`` (``test``): identical weights
   and identical float32 detections at 800x1344 (8 images), RoIPool and
   NMS launched. Step p50 and the phase's wall time are printed.
26. the real-data drill and the single-image tutorial, under
   ``build/chip_smoke_preflight/`` (removed after): ``tools/make_shapes_voc.py``
   writes 8 train and 24 test scenes (a subprocess), and a seeded legacy
   VOC ``frcnn.best.pth.tar`` (``save_torch_checkpoint``); the drill's
   ``main`` (``faster_rcnn_pytorch_tpu_torch/tools/preflight_real_data.py``)
   in this process at the default ``--resize 800`` with
   ``FRT_PREFLIGHT_LIMIT=20``, in float32 (TF32 off) and bfloat16, counts
   reset just before and read just after: the census's ``params`` is the
   model's, RoIPool and NMS launched (NMS twice a predict call), the
   align and IoU kernels never, 20 images taken, and in float32 the
   drill's detections equal those of the first 20 images of one
   unbounded eval of the 24 bit for bit. Then the FPN drill on
   ``tools/make_shapes_coco.py`` scenes (4 and 24) with ``--data_type
   coco --num_classes 91`` and the seeded fresh init, bfloat16: both
   splits counted, the align kernel and NMS launched, RoIPool never. Then
   ``examples/tutorial_torch.py``'s functions on a seeded 375x500 JPEG
   with that checkpoint, bfloat16, at 0.05: detections equal direct
   ``predict`` on its canvas, RoIPool and NMS launched; and the script as
   a subprocess (at its own 0.5, the checkpoint's class head made
   constant so that every roi scores ~1.0): exit 0, more than 0
   detections printed, and ``tutorial_out.png`` the JPEG with their
   boxes drawn. The phase's wall time and the drills' eval img/s are printed
   with the card's name and power limit.
27. main path, FPN dense-scene train: phases 15 and 16 for the FPN
   generation, the gt padded to 640 slots (``FPN_DENSE_MAX_GT``, the
   generation's IoU kernel gate) with 300-500 small boxes an image under
   raw COCO ids: 20 steps in float32 and under bfloat16 autocast, counts
   reset just before and read just after (the IoU match mode once a step,
   its matrix mode never, the align forward and backward and NMS once a
   step; losses finite and falling), peak memory and the stage split
   printed beside phase 15's; then one float32 step through the kernels
   and with ``plain=True``: identical RPN and RoI targets and losses.
28. main path, shapes-VOC training through the port's ``main``:
   ``tools/make_shapes_voc.py`` (a subprocess) writes 800 train and 160
   test scenes under ``build/chip_smoke_shapes/`` (removed after); each
   generation trains from random init for 8 epochs with the recipe of
   ``ACCURACY_SHAPES.json`` (``--resize 320 --max_size 512 --batch_size 8
   --lr 1e-3``, bfloat16; ``tools/shapes_recipe.py``) in this process,
   counts reset just before ``main`` and read after the test CLIs: every
   logged loss finite, the head's forward and backward kernels and NMS
   launched at least once a step, the other head's never, best AP50 >=
   0.55, its curve printed beside the JAX package's 8-epoch records
   (``*_voc_shapes_r3_headcheck``); then the best checkpoint through the
   port's ``test`` CLI at
   ``--dtype float32`` (TF32 off) and ``bfloat16`` on 800 test scenes of
   the same generator (the 160 and 640 more): mAPs within 0.01, their
   detections' greedy pairing printed. The AP50 curve, the train
   loop's img/s and the epochs' wall times are printed.
29. imports: jax and flax were never imported.

The ranks of phases 21, 22 and 24 send their kernel launch counts back
(the slot-lattice align kernel's must stay 0). Its last two lines are the
kernels' JSON record (``launches``: phases 3, 6, 9, 12, 15, 21-24, 25-28; ``serving_launches``: phases 18-20) and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch import serve, serving
from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex
from faster_rcnn_pytorch_tpu_torch.data.loader import canvas_buckets, load_image
from faster_rcnn_pytorch_tpu_torch.engine import demo as demo_mod
from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate
from faster_rcnn_pytorch_tpu_torch.engine.train import BATCH_KEYS, train_one_epoch
from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (
    FPN_CONFIG,
    LEGACY_CONFIG,
    RoITargets,
    RPNTargets,
    build_model,
    device_anchors,
    draw_train_noise,
    forward_train,
    init_weights,
    predict,
    train_losses,
    train_targets,
)
from faster_rcnn_pytorch_tpu_torch.ops import boxes as boxes_mod
from faster_rcnn_pytorch_tpu_torch.ops import nms as nms_mod
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
FPN_DENSE_MAX_GT = 640  # the FPN generation's gate: phase 27's --max_gt
TRAIN_LR = 1e-3
DENSE_SPLIT_STEPS = 6  # a dense scene's stage split: steps 2-6 after the 20
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
BURST = 10  # calls between two events for the RoIPool kernels' back-to-back times
DIST_DIR = os.path.join(BUILD, "chip_smoke_dist")
DDP_CHECKED_STEPS = 3  # phase 21: these steps' losses equal the single process's
DDP_STEPS = 8  # phase 21's steps a generation and dtype; p50 over the last 5
REMAT_STEPS = 5  # phase 23's timed steps a configuration
SAVE_STEPS = 6  # phase 24's steps without a save in flight
SINGLE_PROCESS: dict = {}  # (generation, dtype) -> phases 6 and 12's first losses, p50, img/s


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


def _median_ms(fn, runs: int = 25, warmup: int = 3, burst: int = 1) -> float:
    """Median ms of one call of ``fn`` between two CUDA events. With
    ``burst`` > 1, ``burst`` calls back to back between the events, over
    ``burst``: the host's time to enqueue a call then overlaps the
    device's work on the calls before it, so a kernel shorter than its
    wrapper's host path is timed by its own device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
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


def _pool_inputs(seed: int, b: int, c: int, h: int, w: int, n: int, inside: bool = False):
    """Seeded relu features ``[b, c, h, w]`` and ``[b, n, 4]`` rois in cells
    (random, extents up to half the map; the first of each image
    ``_edge_rois``, with ``inside`` only those inside the map), and the
    generator for what the caller draws next."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.relu(torch.randn(b, c, h, w, generator=g))
    xy = torch.rand(b, n, 2, generator=g) * torch.tensor([w - 4.0, h - 4.0])
    wh = torch.rand(b, n, 2, generator=g) * torch.tensor([w / 2.0, h / 2.0])
    rois = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w * 1.0, h * 1.0]))], -1)
    edge = _edge_rois(h, w)
    if inside:
        edge = edge[((edge >= 0) & (edge <= torch.tensor([w, h, w, h]))).all(1)]
    rois[:, : len(edge)] = edge
    return feats, rois, g


def _check_pool_forward(f, rois, what: str) -> None:
    """The forward kernel bit-exact (values and argmax) with its plain version."""
    out, arg = roi_pool_mod.roi_pool_cuda(f, rois, 1.0, 7, with_argmax=True)
    torch.cuda.synchronize()
    ref, ref_arg = roi_pool_mod.roi_pool_reference(f, rois, 1.0, 7, with_argmax=True)
    _require(
        torch.equal(out, ref) and torch.equal(arg, ref_arg),
        f"roi_pool kernel != plain ({what}): max|d| {float((out.float() - ref.float()).abs().max())}, "
        f"argmax differs at {int((arg != ref_arg).sum())} outputs",
    )


def check_roi_pool_kernel(device) -> dict:
    """The forward kernel at the legacy predict shape (1 image, 300 rois,
    no argmax: the record's times) and train shape (2 images of 128 rois,
    with the argmax the backward needs), bit-exact in both dtypes."""
    t0 = time.time()
    extension()
    print(f"kernel build: {time.time() - t0:.1f}s", flush=True)
    h, w = CANVAS[0] // 16, CANVAS[1] // 16
    record = {
        "name": "roi_pool_forward",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/roi_pool.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/roi_pool_kernel.py:30",
        "max_abs_err": 0.0,  # every output is held bit-exact
        "library_ms": None,  # PyTorch has no RoIPool call (torchvision is not a dependency)
    }
    shapes = (
        ("predict", SEED, 1, 300, False),
        ("train", SEED + 2, TRAIN_BATCH, LEGACY_CONFIG.roi_samples, True),
    )
    for label, seed, b, n, with_argmax in shapes:
        feats, rois, _ = _pool_inputs(seed, b, 512, h, w, n)
        rois = rois.to(device)
        cells, bin_cells = _roi_pool_footprint(rois, h, w)
        for dtype in (torch.float32, torch.bfloat16):
            f = feats.to(device, dtype)
            name = str(dtype).removeprefix("torch.")
            _check_pool_forward(f, rois, f"{label} {name}")
            call = lambda: roi_pool_mod.roi_pool_cuda(f, rois, 1.0, 7, with_argmax)
            ms, burst_ms = _median_ms(call), _median_ms(call, burst=BURST)
            plain_ms = _median_ms(
                lambda: roi_pool_mod.roi_pool_reference(f, rois, 1.0, 7, with_argmax)
            )
            outputs = b * n * f.shape[1] * 49
            size = f.element_size()
            # The map's covered cells read once, the rois, the output (and
            # the int32 argmax) written once; one comparison per bin cell.
            n_bytes = cells * f.shape[1] * size + rois.numel() * 4 + outputs * (size + 4 * with_argmax)
            bound_ms, bound_by = _bound(n_bytes, bin_cells * f.shape[1])
            print(
                f"roi_pool {label} {name} feats {tuple(f.shape)} rois {tuple(rois.shape)}"
                f"{' with argmax' if with_argmax else ''}: bit-exact (values and argmax), "
                f"kernel {ms:.4f} ms ({burst_ms:.4f} back to back), plain {plain_ms:.4f} ms "
                f"(median of 25), bound {bound_ms:.4f} ms ({n_bytes / 1e6:.2f} MB)",
                flush=True,
            )
            if label == "predict" and dtype == torch.float32:
                record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
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


def _check_pool_backward(arg, shape, dtype, g, what: str):
    """The backward kernel against its plain version on the argmax ``arg``:
    integer-valued gradients in ``dtype`` bit-exact (every order of the
    float32 sums is exact), normal ones within 1e-5 * max|ref| of the
    float32 map (shared-memory atomics add in another order). Returns the
    normal gradients, max|d| and max|ref|."""
    ints = torch.randint(-3, 4, arg.shape, generator=g).to(arg.device, dtype)
    got = roi_pool_mod.roi_pool_backward_cuda(ints, arg, shape, dtype)
    torch.cuda.synchronize()
    want = roi_pool_mod.roi_pool_backward_reference(ints, arg, shape, dtype)
    _require(
        got.dtype == dtype and torch.equal(got, want),
        f"roi_pool backward != plain on integer gradients ({what}): "
        f"max|d| {float((got.float() - want.float()).abs().max())}",
    )
    normal = torch.randn(arg.shape, generator=g).to(arg.device, dtype)
    got = roi_pool_mod.roi_pool_backward_cuda(normal, arg, shape, torch.float32)
    want = roi_pool_mod.roi_pool_backward_reference(normal, arg, shape, torch.float32)
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    _require(diff <= 1e-5 * scale, f"roi_pool backward ({what}): max|d| {diff} > 1e-5 * {scale}")
    return normal, diff, scale


def check_roi_pool_backward_kernel(device) -> dict:
    """The backward kernel against its plain version at the train shapes,
    timed beside ``scatter_add_`` on the plain version's prepared index."""
    h, w = CANVAS[0] // 16, CANVAS[1] // 16
    feats, rois, g = _pool_inputs(SEED + 1, TRAIN_BATCH, 512, h, w, LEGACY_CONFIG.roi_samples, inside=True)
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
        name = str(dtype).removeprefix("torch.")
        normal, diff, scale = _check_pool_backward(arg, shape, dtype, g, f"train {name}")
        err = max(err, diff)
        call = lambda: roi_pool_mod.roi_pool_backward_cuda(normal, arg, shape, dtype)
        ms, burst_ms = _median_ms(call), _median_ms(call, burst=BURST)
        plain_ms = _median_ms(
            lambda: roi_pool_mod.roi_pool_backward_reference(normal, arg, shape, dtype)
        )
        size = f.element_size()
        n_bytes = normal.numel() * (size + 4) + f.numel() * size  # grad, argmax, map
        bound_ms, bound_by = _bound(n_bytes, int((arg >= 0).sum()))  # one add each
        print(
            f"roi_pool_backward {name} grad {tuple(normal.shape)} -> feats {shape}: bit-exact on "
            f"integer gradients, max|d| {diff:.3g} (max|ref| {scale:.3g}) on normal ones, "
            f"kernel {ms:.4f} ms ({burst_ms:.4f} back to back), plain {plain_ms:.4f} ms "
            f"(median of 25), bound {bound_ms:.4f} ms ({n_bytes / 1e6:.2f} MB)",
            flush=True,
        )
        if dtype == torch.float32:
            # One PyTorch call computes the same sums: scatter_add_ on the
            # plain version's prepared [B, C, h*w + 1] index.
            b, c, h2, w2 = shape
            flat_g = normal.float().transpose(1, 2).reshape(b, c, -1)
            flat_a = arg.transpose(1, 2).reshape(b, c, -1).long()
            flat_a = torch.where(flat_a >= 0, flat_a, h2 * w2)
            acc = torch.zeros((b, c, h2 * w2 + 1), device=device)
            scatter = lambda: acc.scatter_add_(2, flat_a, flat_g)
            library_ms = _median_ms(scatter)
            record.update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms,
            )
            print(
                f"  scatter_add_ on the prepared index: {library_ms:.4f} ms "
                f"({_median_ms(scatter, burst=BURST):.4f} back to back)",
                flush=True,
            )
    record["max_abs_err"] = err
    return record


def check_roi_pool_large_maps(device) -> None:
    """Both RoIPool kernels on maps whose channel plane exceeds a block's
    232,448 bytes of shared memory in the dtype under test (the forward's
    direct-read route, the backward's row bands), and on a bfloat16 plane
    of 122,880 bytes (a staged forward block above 48 KB), 64 rois each
    with the edge rois: the forward bit-exact, the backward as at the train
    shape."""
    for (c, h, w), dtype in (
        ((16, 240, 256), torch.float32),
        ((16, 340, 352), torch.bfloat16),
        ((16, 240, 256), torch.bfloat16),
    ):
        feats, rois, g = _pool_inputs(SEED + 3, 1, c, h, w, 64)
        f, rois = feats.to(device, dtype), rois.to(device)
        name = f"{str(dtype).removeprefix('torch.')} feats {tuple(f.shape)}"
        _check_pool_forward(f, rois, name)
        _, arg = roi_pool_mod.roi_pool_cuda(f, rois, 1.0, 7, with_argmax=True)
        _, diff, scale = _check_pool_backward(arg, tuple(f.shape), dtype, g, name)
        print(
            f"roi_pool large map {name} ({h * w * f.element_size()} B a plane), 64 rois: forward "
            f"bit-exact; backward bit-exact on integer gradients, max|d| {diff:.3g} "
            f"(max|ref| {scale:.3g}) on normal ones",
            flush=True,
        )


def print_roi_pool_plans() -> None:
    """The launch plans of phase 2's RoIPool shapes on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h, w = CANVAS[0] // 16, CANVAS[1] // 16
    for b, c, h2, w2, n in (
        (1, 512, h, w, 300),
        (TRAIN_BATCH, 512, h, w, LEGACY_CONFIG.roi_samples),
        (1, 16, 240, 256, 64),
        (1, 16, 340, 352, 64),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.empty((), dtype=dtype).element_size()
            fwd = roi_pool_mod.forward_plan(b, c, h2, w2, n, size, 7, sms)
            bwd = roi_pool_mod.backward_plan(b, c, h2, w2, n)
            staged = (
                f"{fwd.grid} blocks of {fwd.chunk_channels} channel(s) x {fwd.chunk_rois} rois, "
                f"{fwd.shared_bytes} B shared"
            )
            print(
                f"roi_pool plans [{b}, {c}, {h2}, {w2}] x {n} rois {str(dtype).removeprefix('torch.')}: "
                f"forward {staged if fwd.shared_bytes else 'direct reads'}; "
                f"backward {bwd.grid} blocks of {bwd.chunk_channels} channel(s) x "
                f"{bwd.band_rows} rows, {bwd.shared_bytes} B shared",
                flush=True,
            )


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


IOU_KERNELS = (boxes_mod.pairwise_iou_cuda, boxes_mod.iou_match_cuda)  # the matrix and match modes


def _iou_launches() -> int:
    return sum(k.launches for k in IOU_KERNELS)


def _iou_inputs(generator, n_props: int, max_gt: int, device):
    """A ``TRAIN_BATCH`` of ``frcnn_targets``' candidates and gt
    (``iou_boxes``, 400 real gt an image; slots 10-19 copies of 0-9, so
    that equal maxima meet in the match) with their masks: 10% of the
    proposals invalid, the appended gt valid where its slot is."""
    pairs = [iou_boxes(generator, n_props, max_gt, 400) for _ in range(TRAIN_BATCH)]
    cand, gt = (torch.stack(t) for t in zip(*pairs))
    gt[:, 10:20] = gt[:, 0:10]
    cand[:, n_props + 10 : n_props + 20] = gt[:, 10:20]
    gt_mask = (torch.arange(max_gt) < 400).expand(TRAIN_BATCH, max_gt).contiguous()
    roi_valid = torch.rand(TRAIN_BATCH, n_props, generator=generator) > 0.1
    cand_valid = torch.cat([roi_valid, gt_mask], 1)
    return (t.to(device) for t in (cand, cand_valid, gt, gt_mask))


def check_iou_kernel(device) -> dict:
    """Both modes of the IoU kernel at the dense train shapes (legacy at
    --max_gt 512, FPN at 640), eps 1e-5 and eps 0 (padded rows meet padded
    rows: the 1e-12 union floor decides): the matrix mode bit for bit
    against ``pairwise_iou_reference`` without a mask, with the gt mask,
    and with it on a width that is not a multiple of 4 (the scalar
    stores); the match mode on the two-image batch against the plain chain
    (``iou_match_reference``), the max bit for bit and the argmax equal.
    Timed one call between two events and back to back (``BURST`` calls),
    beside an empty kernel launched through the same extension (the launch
    floor), the plain versions, and the chain the match replaces on the
    card (per image the matrix mode with the gt mask, ``where`` on the
    candidates' validity, ``max``). The record's ``ms``, ``burst_ms``,
    ``plain_ms`` and bound are the match mode's, the one the main path
    launches (legacy shape, eps 1e-5); the matrix mode's, which no main
    path launches, are its ``matrix_*`` keys."""
    g = torch.Generator().manual_seed(SEED + 9)
    empty = extension().empty_kernel
    floor_ms, floor_burst_ms = _median_ms(empty), _median_ms(empty, burst=BURST)
    print(
        f"empty kernel: {floor_ms:.4f} ms one call, {floor_burst_ms:.4f} ms back to back "
        "(the launch floor)",
        flush=True,
    )
    record = {
        "name": "pairwise_iou",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/iou.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/pallas/iou_kernel.py:25",
        "max_abs_err": 0.0,  # every output is held bit-exact
        "library_ms": None,  # PyTorch has no IoU call (torchvision is not a dependency)
        "floor_ms": floor_ms,
        "floor_burst_ms": floor_burst_ms,
    }
    shapes = (
        ("legacy", LEGACY_CONFIG.post_nms_train, DENSE_MAX_GT),
        ("fpn", FPN_CONFIG.post_nms_train, FPN_DENSE_MAX_GT),
    )
    matrix, match = boxes_mod.pairwise_iou_cuda, boxes_mod.iou_match_cuda
    for generation, n_props, max_gt in shapes:
        cand, cand_valid, gt, gt_mask = _iou_inputs(g, n_props, max_gt, device)
        b, n, m = cand.shape[0], cand.shape[1], gt.shape[1]
        _require(n * m >= boxes_mod.IOU_KERNEL_MIN_PAIRS, f"{n} x {m} is below the kernel's gate")
        a0, v0, g0, m0 = cand[0], cand_valid[0], gt[0], gt_mask[0]
        for eps in (1e-5, 0.0):
            cases = (
                ("matrix", (a0, g0, eps), boxes_mod.pairwise_iou_reference(a0, g0, eps)),
                (
                    "matrix masked",
                    (a0, g0, eps, m0),
                    boxes_mod.pairwise_iou_reference(a0, g0, eps, m0),
                ),
                (
                    f"matrix masked, {m - 3} columns",
                    (a0, g0[: m - 3], eps, m0[: m - 3]),
                    boxes_mod.pairwise_iou_reference(a0, g0[: m - 3], eps, m0[: m - 3]),
                ),
            )
            for what, args, want in cases:
                got = matrix(*args)
                torch.cuda.synchronize()
                _require(
                    got.dtype == torch.float32 and torch.equal(got, want),
                    f"iou {what} != plain ({generation}, eps {eps}): max|d| {float((got - want).abs().max())}",
                )
            got = match(cand, cand_valid, gt, gt_mask, eps)
            torch.cuda.synchronize()
            want = boxes_mod.iou_match_reference(cand, cand_valid, gt, gt_mask, eps)
            _require(
                torch.equal(got[0], want.values) and torch.equal(got[1], want.indices),
                f"iou match != plain ({generation}, eps {eps}): max|d| "
                f"{float((got[0] - want.values).abs().max())}, "
                f"{int((got[1] != want.indices).sum())} argmax differ",
            )
            ties = int((((cases[1][2] == want.values[0][:, None]).sum(1) > 1) & v0).sum())
            floored = int(((a0[:, None, 2] == a0[:, None, 0]) & (g0[None, :, 2] == g0[None, :, 0])).sum())
            mat_call = lambda: matrix(a0, g0, eps)
            match_call = lambda: match(cand, cand_valid, gt, gt_mask, eps)

            def chain():  # what frcnn_targets ran per image before the match mode
                for i in range(b):
                    iou = matrix(cand[i], gt[i], eps, gt_mask[i])
                    torch.where(cand_valid[i][:, None], iou, -1.0).max(dim=1)

            ms, burst_ms = _median_ms(mat_call), _median_ms(mat_call, burst=BURST)
            plain_ms = _median_ms(lambda: boxes_mod.pairwise_iou_reference(a0, g0, eps))
            match_ms, match_burst_ms = _median_ms(match_call), _median_ms(match_call, burst=BURST)
            match_plain_ms = _median_ms(
                lambda: boxes_mod.iou_match_reference(cand, cand_valid, gt, gt_mask, eps)
            )
            chain_ms, chain_burst_ms = _median_ms(chain), _median_ms(chain, burst=BURST)
            # matrix: the [n, m] float32 output and the boxes; 13 operations a
            # pair (4 min/max, 2 subs, 2 clamps, inter, 2 adds, 1 sub, 1 div)
            n_bytes = n * m * 4 + (n + m) * 16
            bound_ms, bound_by = _bound(n_bytes, 13 * n * m)
            # match: the batch's boxes and masks in, max and int64 argmax out;
            # the 13 operations and one comparison a pair
            match_bytes = b * (n + m) * 17 + b * n * 12
            match_bound_ms, match_bound_by = _bound(match_bytes, 14 * b * n * m)
            print(
                f"iou {generation} eps {eps}: matrix [{n}, 4] x [{m}, 4] bit-exact with and without the mask "
                f"({floored} zero-width pairs), kernel {ms:.4f} ms ({burst_ms:.4f} back to back), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({n_bytes / 1e6:.2f} MB, {bound_by}); match "
                f"[{b}, {n}, 4] x [{b}, {m}, 4] equal to the plain chain ({ties} valid rows with tied "
                f"maxima in image 0), kernel {match_ms:.4f} ms ({match_burst_ms:.4f} back to back), plain "
                f"{match_plain_ms:.4f} ms, bound {match_bound_ms:.5f} ms ({match_bytes / 1e6:.3f} MB, "
                f"{match_bound_by}); the per-image chain it replaces {chain_ms:.4f} ms "
                f"({chain_burst_ms:.4f} back to back) (medians of 25)",
                flush=True,
            )
            if generation == "legacy" and eps:
                record.update(
                    ms=match_ms, burst_ms=match_burst_ms, plain_ms=match_plain_ms,
                    bound_ms=match_bound_ms, bound_by=match_bound_by, matrix_ms=ms,
                    matrix_burst_ms=burst_ms, matrix_plain_ms=plain_ms, matrix_bound_ms=bound_ms,
                    matrix_bound_by=bound_by, chain_ms=chain_ms, chain_burst_ms=chain_burst_ms,
                    # run_train and the predict phases require no matrix launch
                    matrix_launches=0,
                )
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


TRAIN_STAGES = ("backbone+rpn fwd", "propose+targets", "head+loss fwd", "backward", "sgd")


def dense_max_gt(generation: str) -> int:
    """A dense scene's gt slots: past the generation's IoU kernel gate."""
    return DENSE_MAX_GT if generation == "legacy" else FPN_DENSE_MAX_GT


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def train_stage_rows(state, cfg, batch: dict, dtype, steps: int, generator):
    """``steps`` train steps of ``state`` on ``batch`` (``dtype``: autocast
    unless float32), split into ``TRAIN_STAGES`` by a device sync between
    them. Returns per step the seconds of each stage and of the whole
    step, and per step the NMS and IoU match launches."""
    model = state.model
    device = batch["image"].device
    schedule = make_lr_schedule("constant", TRAIN_LR, 1, steps)
    canvas_hw = tuple(batch["image"].shape[1:3])
    anchors = device_anchors(model, *canvas_hw, device)
    n_cand = cfg.post_nms_train + batch["gt_boxes"].shape[1]
    autocast = torch.autocast(device.type, dtype=torch.bfloat16, enabled=dtype != torch.float32)
    rows, launches = [], []
    for _ in range(steps):
        before = (NMS_KERNEL.launches, boxes_mod.iou_match_cuda.launches)
        t0 = _sync(device)
        state.optimizer.zero_grad(set_to_none=True)
        with autocast:
            feats = model.features(batch["image"].permute(0, 3, 1, 2).contiguous())
            rpn_cls, rpn_reg = model.rpn_out(feats)
            t1 = _sync(device)
            noise = draw_train_noise(generator, batch["image"].shape[0], anchors.shape[0], n_cand, device)
            targets = train_targets(cfg, anchors, rpn_cls, rpn_reg, *(batch[k] for k in BATCH_KEYS[1:]), noise)
            t2 = _sync(device)
            out = train_losses(model, cfg, feats, rpn_cls, rpn_reg, *targets, canvas_hw)
            t3 = _sync(device)
        out.losses.total.backward()
        t4 = _sync(device)
        apply_gradients(state, schedule)
        t5 = _sync(device)
        rows.append([t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t5 - t0])
        launches.append((NMS_KERNEL.launches - before[0], boxes_mod.iou_match_cuda.launches - before[1]))
    return rows, launches


def train_epoch(model, cfg, batch: dict, steps: int, name: str, autocast_dtype=None):
    """``steps`` train steps of ``model`` on one repeated batch through
    ``train_one_epoch`` and ``parallel.train_step`` (constant LR), the
    counts of ``PATH_KERNELS`` reset just before and read just after;
    returns those counts, the step losses and the step timer."""
    state = init_train_state(model, make_optimizer(model))
    schedule = make_lr_schedule("constant", TRAIN_LR, 1, steps)
    step_fn = make_train_step(cfg, schedule, autocast_dtype=autocast_dtype)
    timer = StepTimer()

    def timed_step(state, batch, generator):
        timer.start()
        metrics = step_fn(state, batch, generator)
        torch.cuda.synchronize()
        timer.stop()
        return metrics

    recorder = LossRecorder()
    opts = SimpleNamespace(seed=SEED, vis_step=1, log_dir=LOG_DIR, name=name, keep_checkpoints=1)
    for k in PATH_KERNELS:
        k.launches = 0
    train_one_epoch(state, timed_step, RepeatedBatch(batch, steps), 0, opts, schedule, recorder)
    counts = {k.__name__: k.launches for k in PATH_KERNELS}
    shutil.rmtree(LOG_DIR)
    return counts, recorder.losses, timer, state


def run_train(
    dtype_name: str, device, generation: str = "legacy", dense: bool = False
) -> tuple[int, int, int, int]:
    """20 full-width train steps through ``train_one_epoch``; returns the
    launch counts of the generation's head kernels (forward, backward) and
    of the IoU kernel in the run, and requires the other generation's
    kernels to stay idle. ``dense``: gt padded to ``dense_max_gt`` slots
    (512 legacy, 640 FPN) with ``DENSE_BOXES`` boxes per image, past the
    IoU kernel's gate, so its match mode runs once per step for the batch
    and its matrix mode never; otherwise (100 slots) neither. The NMS
    kernel runs once a step (the batch's proposals); its launches are
    returned last. The peak ``max_memory_allocated`` of the run is
    printed; for a dense scene also the stages of ``DENSE_SPLIT_STEPS``
    more steps (``train_stage_rows``) and propose + targets' share."""
    dtype = set_numerics(dtype_name)
    cfg, labels = _train_setup(generation)
    seed = SEED + (4 if generation == "legacy" else 6) + (10 if dense else 0)
    gt = dict(max_gt=dense_max_gt(generation), boxes=DENSE_BOXES) if dense else {}
    name = f"{generation}{' dense' if dense else ''} {dtype_name}"
    batch = synthetic_train_batch(CANVAS, seed, labels=labels, **gt)
    torch.cuda.reset_peak_memory_stats(device)
    counts, losses, timer, state = train_epoch(
        _new_model(generation).to(device), cfg, batch,
        TRAIN_STEPS, f"train_{name.replace(' ', '_')}", autocast_dtype=dtype if dtype != torch.float32 else None,
    )
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    fwd, bwd = (counts.pop(k.__name__) for k in _head_kernels(generation))
    nms = counts.pop(NMS_KERNEL.__name__)
    iou = counts.pop(boxes_mod.iou_match_cuda.__name__)
    matrix = counts.pop(boxes_mod.pairwise_iou_cuda.__name__)
    _require(len(losses) == TRAIN_STEPS, f"{len(losses)} of {TRAIN_STEPS} losses logged")
    _require(bool(np.isfinite(losses).all()), f"{name} train: non-finite loss {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    _require(last < first, f"{name} train: loss did not fall ({first} -> {last})")
    _require(bwd == TRAIN_STEPS, f"{name} train: {bwd} backward launches, want {TRAIN_STEPS}")
    _require(fwd == TRAIN_STEPS, f"{name} train: {fwd} forward launches, want {TRAIN_STEPS}")
    _require(nms == TRAIN_STEPS, f"{name} train: {nms} NMS launches, want {TRAIN_STEPS} (the batch's proposals)")
    want_iou = TRAIN_STEPS if dense else 0
    _require(iou == want_iou, f"{name} train: {iou} IoU match launches, want {want_iou}")
    _require(matrix == 0, f"{name} train: {matrix} IoU matrix launches, want 0")
    _require(not any(counts.values()), f"{name} train launched another head's kernels: {counts}")
    _require_slots_idle(f"{name} train")
    steady = timer.times[5:]
    if not dense:  # phase 21 holds its DDP steps against these
        SINGLE_PROCESS[(generation, dtype_name)] = {
            "losses": losses[:DDP_CHECKED_STEPS],
            "p50_ms": 1000 * timer.p50(),
            "img_s": TRAIN_BATCH * len(steady) / sum(steady),
        }
    print(
        f"train {name} {CANVAS[0]}x{CANVAS[1]} batch {TRAIN_BATCH}"
        f"{f' gt slots {dense_max_gt(generation)}' if dense else ''}: "
        f"{TRAIN_BATCH * len(steady) / sum(steady):.2f} img/s over steps 6-{TRAIN_STEPS} "
        f"(step p50 {1000 * timer.p50():.1f} ms), mean loss steps 1-5 {first:.4f} -> "
        f"16-20 {last:.4f}, launches fwd {fwd} bwd {bwd} iou {iou} nms {nms}, other kernels {counts}, "
        f"peak max_memory_allocated {peak_gib:.2f} GiB",
        flush=True,
    )
    if dense:
        rows, split_launches = train_stage_rows(
            state, cfg, _to_device(batch, device), dtype, DENSE_SPLIT_STEPS,
            torch.Generator(device=device).manual_seed(SEED),
        )
        _require(all(n == (1, 1) for n in split_launches), f"{name} split: launches {split_launches}")
        med = [1000 * statistics.median(r[i] for r in rows[1:]) for i in range(len(TRAIN_STAGES) + 1)]
        print(
            f"  stages of {name} (ms a step, median of steps 2-{DENSE_SPLIT_STEPS}, a sync between "
            f"stages): {', '.join(f'{k} {v:.2f}' for k, v in zip(TRAIN_STAGES, med))}, total "
            f"{med[-1]:.2f}; propose+targets share {med[1] / med[-1]:.3f}",
            flush=True,
        )
    return fwd, bwd, iou, nms


def check_dense_targets_kernel_vs_plain(device, generation: str = "legacy") -> None:
    """One float32 dense-scene step of ``generation`` (phase 16: legacy at
    512 gt slots; phase 27: FPN at 640) from the same weights and noise
    through the IoU kernel and through ``plain=True``: identical RPN and
    RoI targets (rois, labels, is_pos, valid, reg targets), one launch of
    the match mode for the batch against none, and identical losses."""
    set_numerics("float32")
    cfg, labels = _train_setup(generation)
    max_gt = dense_max_gt(generation)
    model = _new_model(generation).to(device)
    batch = _to_device(
        synthetic_train_batch(CANVAS, SEED + 12, labels=labels, max_gt=max_gt, boxes=DENSE_BOXES), device
    )
    anchors = torch.from_numpy(model.canvas_anchors(*CANVAS)).to(device)
    noise = draw_train_noise(
        torch.Generator(device=device).manual_seed(SEED), TRAIN_BATCH, anchors.shape[0],
        cfg.post_nms_train + max_gt, device,
    )
    iou_k = boxes_mod.iou_match_cuda
    with torch.no_grad():
        feats = model.features(batch["image"].permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
    targets = []
    for plain in (False, True):
        before = (iou_k.launches, NMS_KERNEL.launches)
        targets.append(
            train_targets(
                cfg, anchors, rpn_cls, rpn_reg, *(batch[k] for k in BATCH_KEYS[1:]), noise, plain=plain
            )
        )
        torch.cuda.synchronize()
        after = (iou_k.launches, NMS_KERNEL.launches)
        want = before if plain else tuple(b + 1 for b in before)
        _require(after == want, f"IoU match and NMS launches {before} -> {after} (plain={plain})")
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
        _require(iou_k.launches == before + (0 if plain else 1), "forward_train IoU match launches")
        losses.append(_loss_vector(out))
    _require(torch.equal(*losses), f"dense losses differ: {losses[0].tolist()} vs {losses[1].tolist()}")
    n_real = batch["gt_mask"].sum(1).tolist()
    print(
        f"dense train step {generation} float32 ({n_real} of {max_gt} gt slots real): RoI and RPN "
        f"targets identical with the IoU match and NMS kernels and with the plain ones ({int(k_roi.is_pos.sum())} "
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
        before = (fwd_k.launches, bwd_k.launches, NMS_KERNEL.launches)
        out = forward_train(model, cfg, *(batch[k] for k in BATCH_KEYS), noise=noise, plain=plain)
        out.losses.total.backward()
        torch.cuda.synchronize()
        after = (fwd_k.launches, bwd_k.launches, NMS_KERNEL.launches)
        want = before if plain else tuple(b + 1 for b in before)
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
        f"kernels and with the plain head ops and NMS ({', '.join(f'{v:.5f}' for v in k_loss.tolist())})",
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


def run_fpn_predict(device) -> tuple[int, int, dict]:
    """Full-width FPN predict in float32 and bfloat16, counts reset just
    before and read just after each: one align launch and two NMS launches
    (proposals, per-class) per predict call, no RoIPool launch, at least
    one detection per image. Returns the align and NMS launches of both
    runs and the float32 detections."""
    launches = nms_launches = 0
    detections = {}
    for dtype_name in ("float32", "bfloat16"):
        model = _new_model("fpn")
        # Warm-up (cuDNN and cuBLAS handles, first launches), outside the counts.
        run_predict(model, dtype_name, device, _fpn_loader(SEED + 4, FPN_BATCH), "fpn")
        loader = _fpn_loader(SEED + 5)
        roi_align_mod.multiscale_roi_align_cuda.launches = 0
        roi_pool_mod.roi_pool_cuda.launches = 0
        NMS_KERNEL.launches = 0
        for k in IOU_KERNELS:
            k.launches = 0
        result, counts = run_predict(model, dtype_name, device, loader, "fpn")
        align = roi_align_mod.multiscale_roi_align_cuda.launches
        pool = roi_pool_mod.roi_pool_cuda.launches
        nms = NMS_KERNEL.launches
        calls = len(loader.batches)
        _require(nms == 2 * calls, f"{dtype_name} FPN predict: {nms} NMS launches for {calls} calls")
        _require(align == calls, f"{dtype_name} FPN predict: {align} align launches for {calls} calls")
        _require(pool == 0, f"{dtype_name} FPN predict launched RoIPool {pool} times")
        _require(_iou_launches() == 0, f"{dtype_name} FPN predict launched the IoU kernel")
        _require_slots_idle(f"{dtype_name} FPN predict")
        _require(min(counts) > 0, f"{dtype_name} FPN predict: an image without detections {counts}")
        launches += align
        nms_launches += nms
        with torch.no_grad():
            images = torch.from_numpy(loader.batches[0]["image"]).to(device)
            feats = model.features(images.permute(0, 3, 1, 2).to(next(model.parameters()).dtype))
        print(
            f"  P2..P6 std ({dtype_name}): "
            + " ".join(f"{float(f.float().std()):.3f}" for f in feats)
            + f"; align launches {align} for {calls} predict calls, NMS {nms}, RoIPool {pool}",
            flush=True,
        )
        if dtype_name == "float32":
            detections = result["detections"]
    return launches, nms_launches, detections


# (the call sites of ops/nms.py: what, segments, n, post_k, threshold, the plain sweep's tile)
NMS_SITES = (
    ("proposals, legacy predict", 1, LEGACY_CONFIG.pre_nms_test, LEGACY_CONFIG.post_nms_test, 0.7, 512),
    ("proposals, legacy train", TRAIN_BATCH, LEGACY_CONFIG.pre_nms_train, LEGACY_CONFIG.post_nms_train, 0.7, 1024),
    ("proposals, FPN predict", FPN_BATCH, FPN_CONFIG.pre_nms_test, FPN_CONFIG.post_nms_test, 0.7, 512),
    ("proposals, FPN train", TRAIN_BATCH, FPN_CONFIG.pre_nms_train, FPN_CONFIG.post_nms_train, 0.7, 512),
    ("per-class, legacy (offset pass)", 1, (NUM_CLASSES - 1) * LEGACY_CONFIG.post_nms_test, 100, 0.3, 256),
    ("per-class, FPN (compact + 90 classes)", FPN_BATCH * FPN_CLASSES, FPN_CONFIG.post_nms_test, 100, 0.3, 256),
)
NMS_KERNEL = nms_mod.nms_segments_cuda


def nms_segments_inputs(seed: int, s: int, n: int, shift_classes: int = 0, fpn_passes: bool = False):
    """``s`` score-sorted segments of ``n`` boxes in canvas [0, 1] units:
    RPN-like clumps around a few centres, exact duplicates of a neighbour
    (tied scores at equal boxes), degenerate and zero-area boxes, scattered
    boxes, scattered invalid entries and an invalid tail. ``shift_classes``:
    each box shifted into its class's cell, ``class * (max + 1)``, as the
    offset pass shifts them. ``fpn_passes``: segments are images' compact
    segment then their ``FPN_CLASSES - 1`` class segments, and image 0 takes
    the compact pass, the others the per-class one (the pass not taken is
    all invalid, as ``multiclass_nms_batch`` masks it)."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((s, n, 4), np.float32)
    valid = np.zeros((s, n), bool)
    for i in range(s):
        centres = rs.uniform(0.2, 0.8, size=(6, 2))
        c = centres[rs.randint(0, 6, size=n)] + rs.normal(0, 0.03, size=(n, 2))
        wh = rs.uniform(0.02, 0.3, size=(n, 2))
        b = np.concatenate([c - wh / 2, c + wh / 2], 1).clip(0, 1)
        m = len(b[::7])
        xy = rs.uniform(0, 0.8, size=(m, 2))
        b[::7] = np.concatenate([xy, np.minimum(xy + rs.uniform(0.02, 0.4, size=(m, 2)), 1)], 1)
        b[5::11] = b[4::11][: len(b[5::11])]  # exact duplicates
        b[3::13, 2:] = b[3::13, :2]  # zero area
        b[9::17, 2] = b[9::17, 0]  # zero width
        b[0] = b[1]
        if shift_classes:
            b = b + (rs.randint(0, shift_classes, size=n) * (b.max() + 1.0))[:, None]
        boxes[i] = b
        tail = n - rs.randint(0, n // 4 + 1)
        valid[i, :tail] = rs.uniform(size=tail) > 0.1
    if fpn_passes:
        per_image = valid.reshape(-1, FPN_CLASSES, n)
        per_image[0, 1:] = False  # image 0: the compact pass
        per_image[1:, 0] = False  # the others: the per-class pass
    return boxes, valid


def _greedy_pairs(boxes, valid, keep, count, thr: float, post_k: int) -> int:
    """IoU pairs the sequential greedy tests on these inputs: each valid box
    it reaches meets the kept boxes before it, in order, until the first one
    that suppresses it (all of them if it is kept); it stops at the
    ``post_k``-th kept box."""
    total = 0
    for s in range(boxes.shape[0]):
        k = keep[s, : int(count[s])].long()
        if k.numel() == 0:
            continue
        last = int(k[-1]) if int(count[s]) == post_k else boxes.shape[1] - 1
        cand = boxes[s, : last + 1]
        before = k[None, :] < torch.arange(last + 1, device=boxes.device)[:, None]
        hit = (boxes_mod.box_iou(cand, boxes[s, k])[0] > thr) & before
        tests = torch.where(hit.any(1), hit.int().argmax(1) + 1, before.sum(1))
        total += int(tests[valid[s, : last + 1]].sum())
    return total


def _cluster_pairs(valid, keep, count, post_k: int) -> int:
    """Pairs the cluster design covers on these inputs: in each tile of 64
    that the kernel works on, every valid candidate against every box kept
    before the tile (no CTA stops another's test, so this bounds what the
    CTAs test; a thread stops at its first hit), plus the candidates' pairs
    within the tile."""
    tile = nms_mod.KERNEL_TILE
    n = valid.shape[1]
    n_tiles = -(-n // tile)
    total = 0
    for s in range(valid.shape[0]):
        cand = torch.nn.functional.pad(valid[s], (0, n_tiles * tile - n)).view(n_tiles, tile).sum(1)
        kept = torch.bincount(keep[s, : int(count[s])].long() // tile, minlength=n_tiles)
        before = kept.cumsum(0) - kept
        c, b = cand[before < post_k], before[before < post_k]
        total += int((c * b + c * (c - 1) // 2).sum())
    return total


def check_nms_mid_tile_cut(device) -> None:
    """The legacy train proposals (``NMS_SITES`` row 2's shape and inputs)
    with ``post_k`` cut inside a kernel tile: the smallest ``post_k`` from
    1000 whose next survivor lies in the same tile of 64 as the
    ``post_k``-th in every segment. At 8 and 16 CTAs a segment (16 where the
    card runs such clusters), keep and counts identical with the plain
    sweep."""
    what, s, n, _, thr, tile = NMS_SITES[1]
    boxes, valid = nms_segments_inputs(SEED + 21, s, n)
    tb, tv = torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)
    full, full_count = nms_mod.nms_segments_reference(tb, tv, thr, n, tile)
    t = full.long() // nms_mod.KERNEL_TILE
    same = (t[:, :-1] == t[:, 1:]) & (t[:, 1:] >= 0)
    cut = next((k for k in range(1000, int(full_count.min())) if bool(same[:, k - 1].all())), None)
    _require(cut is not None, f"nms {what}: no post_k from 1000 cuts every segment inside a tile")
    want_keep, want_count = nms_mod.nms_segments_reference(tb, tv, thr, cut, tile)
    wide = nms_mod.launch_plan(device, s, cut).width == nms_mod.WIDE
    for width in (nms_mod.PORTABLE_WIDTH, nms_mod.WIDE)[: 1 + wide]:
        keep, count = NMS_KERNEL(tb, tv, thr, cut, width=width)
        torch.cuda.synchronize()
        _require(
            torch.equal(keep, want_keep) and torch.equal(count, want_count),
            f"nms {what} cut at post_k {cut} mid-tile: the kernel at {width} CTAs differs from the plain sweep",
        )
        print(
            f"nms {what} cut mid-tile at post_k {cut} (tiles {t[:, cut - 1].tolist()}): keep and counts "
            f"identical with the plain sweep at {width} CTAs a segment",
            flush=True,
        )


def check_nms_kernel(device) -> dict:
    """The segmented NMS kernel at every call site of ``ops/nms.py`` (the
    batch's proposals of either generation at predict and train budgets, the
    legacy offset pass, the FPN compact and per-class passes) against
    ``nms_segments_reference`` on ``nms_segments_inputs``: ``keep`` and the
    counts identical. Timed one call and back to back, beside the launch
    floor and the plain version on the card (the host-synchronised sweep it
    replaces, at the call site's tile). Bound: the boxes, flags and outputs
    at 3.35 TB/s, or the pairs the greedy tests on these inputs
    (``_greedy_pairs``) at 14 operations each, at 67 TFLOP/s. The record's
    numbers are the FPN per-class row's, the call that was 73.7 ms of an
    FPN image's predict before the kernel."""
    empty = extension().empty_kernel
    floor_ms, floor_burst_ms = _median_ms(empty), _median_ms(empty, burst=BURST)
    rows = []
    for i, (what, s, n, post_k, thr, tile) in enumerate(NMS_SITES):
        shift = NUM_CLASSES - 1 if "offset" in what else 0
        boxes, valid = nms_segments_inputs(SEED + 20 + i, s, n, shift, "compact" in what)
        tb, tv = torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)
        keep, count = NMS_KERNEL(tb, tv, thr, post_k)
        torch.cuda.synchronize()
        want_keep, want_count = nms_mod.nms_segments_reference(tb, tv, thr, post_k, tile)
        _require(
            torch.equal(keep, want_keep) and torch.equal(count, want_count),
            f"nms {what}: {int((keep != want_keep).any(1).sum())} segments differ from the plain sweep",
        )
        call = lambda: NMS_KERNEL(tb, tv, thr, post_k)  # noqa: E731
        ms, burst_ms = _median_ms(call), _median_ms(call, burst=BURST)
        plain_ms = _median_ms(lambda: nms_mod.nms_segments_reference(tb, tv, thr, post_k, tile), runs=5, warmup=1)
        pairs = _greedy_pairs(tb, tv, keep, count, thr, post_k)
        covered = _cluster_pairs(tv, keep, count, post_k)
        width = nms_mod.launch_plan(device, s, post_k).width
        n_bytes = s * n * 17 + s * post_k * 4 + s * 4
        bound_ms, bound_by = _bound(n_bytes, 14 * pairs)
        rows.append(
            dict(site=what, segments=s, n=n, post_k=post_k, ms=ms, burst_ms=burst_ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, kept=int(count.sum()), width=width,
                 covered_pairs=covered)
        )
        print(
            f"nms {what}: [{s}, {n}, 4] -> [{s}, {post_k}] thr {thr}, keep and counts identical with the "
            f"plain sweep ({int(count.sum())} kept, {int(tv.sum())} valid), clusters of {width} CTAs, "
            f"kernel {ms:.4f} ms ({burst_ms:.4f} back to back), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({n_bytes / 1e6:.3f} MB, {pairs} pairs tested by the greedy, {covered} "
            f"covered by the clusters, {bound_by})",
            flush=True,
        )
    check_nms_mid_tile_cut(device)
    print(f"nms launch floor (empty kernel): {floor_ms:.4f} ms one call, {floor_burst_ms:.4f} back to back", flush=True)
    main = rows[-1]
    return {
        "name": "nms",
        "route": "cuda",
        "source": "faster_rcnn_pytorch_tpu_torch/ops/cuda/nms.cu",
        "replaces": "faster_rcnn_pytorch_tpu/ops/nms.py:84 (no Pallas kernel: an XLA lax.while_loop)",
        "max_abs_err": 0.0,  # keep and counts are held identical
        "library_ms": None,  # PyTorch has no NMS call (torchvision is not a dependency)
        **{k: main[k] for k in ("ms", "burst_ms", "plain_ms", "bound_ms", "bound_by")},
        "floor_ms": floor_ms,
        "floor_burst_ms": floor_burst_ms,
        "sites": rows,
    }


def _serving_counts() -> tuple[int, int, int]:
    return (
        roi_pool_mod.roi_pool_cuda.launches,
        roi_align_mod.multiscale_roi_align_cuda.launches,
        NMS_KERNEL.launches,
    )


def _seeded_canvases(seed: int, b: int, canvas, device):
    g = np.random.default_rng(seed)
    images = np.zeros((b, *canvas, 3), np.float32)
    extents = np.zeros((b, 2), np.float32)
    for i in range(b):
        rh, rw = int(canvas[0] * (1.0 - 0.15 * i)), int(canvas[1] * (0.9 - 0.1 * i))
        images[i, :rh, :rw] = g.standard_normal((rh, rw, 3), dtype=np.float32)
        extents[i] = (rw / canvas[1], rh / canvas[0])
    return torch.from_numpy(images).to(device), torch.from_numpy(extents).to(device)


def _serving_model(generation: str, device):
    set_numerics("bfloat16")
    cfg = LEGACY_CONFIG if generation == "legacy" else FPN_CONFIG
    return prepare_for_inference(_new_model(generation), device, torch.bfloat16), cfg


def check_sync_free_predict(device) -> None:
    """Full-width bfloat16 predict, legacy at batch 1 and FPN at batch 2,
    with the canvas anchors already on the device (one call before), under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation synchronises
    with the host."""
    for generation, batch in (("legacy", 1), ("fpn", FPN_BATCH)):
        model, cfg = _serving_model(generation, device)
        images, extents = _seeded_canvases(SEED + 30, batch, CANVAS, device)
        predict(model, cfg, images, extents, THRESHOLD)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            det = predict(model, cfg, images, extents, THRESHOLD)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(
            f"sync-free predict {generation} bfloat16 batch {batch}: no host synchronisation under "
            f"set_sync_debug_mode('error'), {int(det.valid.sum())} detections",
            flush=True,
        )


def run_export(device) -> tuple[str, dict]:
    """``serving.export_predict`` into ``build/chip_smoke_export/``: legacy
    bfloat16 at batch 1 in both buckets of ``canvas_buckets(800, 1333)``,
    FPN bfloat16 at batch 2 in the landscape bucket, and a legacy artifact
    whose weights are a params sidecar. Each, loaded back with
    ``load_artifact``, gives packed detections bit-identical to direct
    ``predict`` on seeded canvases, and the call raises the RoIPool or align
    count and the NMS count. Returns the FPN export dir (for the server)
    and the launches of the loaded artifacts' calls."""
    out = os.path.join(BUILD, "chip_smoke_export")
    shutil.rmtree(out, ignore_errors=True)
    launches = [0, 0, 0]
    jobs = [("legacy", 1, c, False) for c in canvas_buckets(800, 1333)]
    jobs += [("fpn", FPN_BATCH, CANVAS, False), ("legacy", 1, CANVAS, True)]
    models = {g: _serving_model(g, device) for g in ("legacy", "fpn")}
    for generation, batch, canvas, sidecar in jobs:
        model, cfg = models[generation]
        sub = os.path.join(out, f"{generation}{'_sidecar' if sidecar else ''}")
        os.makedirs(sub, exist_ok=True)
        t0 = time.time()
        exported = serving.export_predict(model, cfg, canvas, batch, THRESHOLD, params_as_args=sidecar)
        name = serving.artifact_name(canvas, batch)
        path = os.path.join(sub, name)
        serving.save_artifact(exported, path)
        export_s = time.time() - t0
        entry = {"file": name, "canvas_hw": list(canvas), "batch": batch, "platforms": [device.type]}
        extra = {
            "model_generation": generation,
            "data_type": "voc" if generation == "legacy" else "coco",
            "num_classes": cfg.num_classes,
            "score_threshold": THRESHOLD,
        }
        if sidecar:
            entry["params_as_args"] = True
            serving.save_params_sidecar(model, os.path.join(sub, serving.PARAMS_SIDECAR))
            extra["params_file"] = serving.PARAMS_SIDECAR
        serving.write_manifest(sub, [entry], extra=extra)
        call = serving.load_artifact(path)
        if sidecar:
            params = serving.load_params_sidecar(os.path.join(sub, serving.PARAMS_SIDECAR), device)
            call = functools.partial(call, params)
        images, extents = _seeded_canvases(SEED + 31, batch, canvas, device)
        want = serving.pack_detections(predict(model, cfg, images, extents, THRESHOLD))
        before = _serving_counts()
        with torch.no_grad():
            got = call(images, extents)
        torch.cuda.synchronize()
        after = _serving_counts()
        rose = [a - b for a, b in zip(after, before)]
        head = 0 if generation == "legacy" else 1
        _require(rose[head] > 0 and rose[2] > 0, f"{name}: the artifact's call launched {rose}")
        _require(torch.equal(got, want), f"{generation} {name}: the artifact differs from direct predict")
        launches = [x + r for x, r in zip(launches, rose)]
        with torch.no_grad():
            ms = _median_ms(lambda: call(images, extents), runs=10)
        direct_ms = _median_ms(lambda: predict(model, cfg, images, extents, THRESHOLD), runs=10)
        size = os.path.getsize(path) / 1e6
        side_mb = os.path.getsize(os.path.join(sub, serving.PARAMS_SIDECAR)) / 1e6 if sidecar else 0.0
        print(
            f"export {generation} bfloat16 {name}{' (params sidecar, ' + f'{side_mb:.1f} MB)' if sidecar else ''}: "
            f"{size:.1f} MB, exported in {export_s:.1f} s, packed detections bit-identical to direct "
            f"predict ({int(got[..., 6].sum())} detections), launches RoIPool/align/NMS {rose}, "
            f"{ms:.2f} ms a call against direct predict {direct_ms:.2f} ms",
            flush=True,
        )
    return os.path.join(out, "fpn"), dict(zip(("roi_pool", "align", "nms"), launches))


def _jpeg(seed: int, h: int, w: int) -> bytes:
    from PIL import Image

    g = np.random.default_rng(seed)
    img = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[h // 4 : h // 2, w // 3 : w // 2] = (220, 40, 40)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def run_serve(device, export_dir: str, requests: int = 16) -> dict:
    """``serve.InferenceServer`` over the FPN export dir (batch 2), with
    ``batch_wait_ms`` 20, behind its HTTP handler on ``127.0.0.1`` port 0:
    ``requests`` concurrent ``POST /detect`` of seeded synthetic JPEGs. Every
    dispatch's packed output equals direct ``predict`` on the same batch,
    every response equals its row of that output through
    ``detections_to_pixels``, and ``/metrics`` counts every request and
    fewer dispatches. Returns the launches of the run."""
    server = serve.InferenceServer(export_dir, batch_wait_ms=20, device=device)
    server.warmup()
    dispatched = []
    dispatch = server._batcher._dispatch

    def recording(bucket, images, extents):
        out = dispatch(bucket, images, extents)
        dispatched.append((bucket, images.copy(), extents.copy(), out))
        return out

    server._batcher._dispatch = recording
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    sizes = [(480 + 8 * i, 640 + 16 * i) for i in range(requests)]
    bodies = [_jpeg(SEED + 40 + i, *sizes[i]) for i in range(requests)]
    outs, lat = {}, {}
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def fire(i):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{base}/detect", data=bodies[i], method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            outs[i] = json.load(r)
        lat[i] = time.perf_counter() - t0

    before = _serving_counts()
    threads = [threading.Thread(target=fire, args=(i,)) for i in range(requests)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
    rose = [a - b for a, b in zip(_serving_counts(), before)]
    _require(len(outs) == requests, f"{len(outs)} of {requests} responses")
    _require(metrics["requests"] == requests and metrics["errors"] == 0, f"metrics {metrics}")
    _require(metrics["dispatches"] < requests, f"{metrics['dispatches']} dispatches for {requests} requests")
    _require(rose[1] > 0 and rose[2] > 0, f"the server's dispatches launched {rose}")
    model, cfg = _serving_model("fpn", device)
    for bucket, images, extents, out in dispatched:
        want = serving.pack_detections(
            predict(model, cfg, torch.from_numpy(images).to(device), torch.from_numpy(extents).to(device), THRESHOLD)
        ).cpu().numpy()
        _require(np.array_equal(out, want), "a dispatch differs from direct predict on its batch")
    n_dets = 0
    for i in range(requests):
        raw = serve.decode_image_bytes(bodies[i])
        canvas_hw = tuple(outs[i]["bucket"][1:])
        canvas, _, scale = serve.preprocess(raw, canvas_hw)
        rows = [
            out[slot] for _, images, _, out in dispatched for slot in range(len(images))
            if np.array_equal(images[slot], canvas)
        ]
        _require(len(rows) == 1, f"request {i}: its canvas is in {len(rows)} dispatches")
        want = serve.detections_to_pixels(rows[0], canvas_hw, scale, (raw.shape[1], raw.shape[0]), None)
        got = [{k: d[k] for k in ("box", "label", "score")} for d in outs[i]["detections"]]
        _require(got == want, f"request {i}: the response differs from direct predict")
        n_dets += len(got)
    ms = sorted(1e3 * v for v in lat.values())
    print(
        f"serve FPN bfloat16 batch 2 (batch_wait_ms 20): {requests} concurrent requests in {wall:.2f} s, "
        f"{requests / wall:.2f} requests/s, client p50 {ms[len(ms) // 2]:.1f} ms p99 "
        f"{ms[min(len(ms) - 1, int(0.99 * len(ms)))]:.1f} ms, server p50 {metrics['latency_ms']['p50']} ms "
        f"p99 {metrics['latency_ms']['p99']} ms, {metrics['dispatches']} dispatches "
        f"(groups {metrics['batch_hist']}), every response equal to direct predict ({n_dets} detections), "
        f"launches RoIPool/align/NMS {rose}",
        flush=True,
    )
    return dict(zip(("roi_pool", "align", "nms"), rose))


def run_demo(device) -> dict:
    """``engine.demo.demo`` over 4 seeded JPEGs under
    ``build/chip_smoke_demo/`` with the legacy bfloat16 model: each image's
    pixel detections equal direct ``predict`` at the demo's /64 bucket,
    mapped as the demo maps them. Returns the launches of the demo."""
    from PIL import Image

    root = os.path.join(BUILD, "chip_smoke_demo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sizes = ((480, 640), (600, 800), (375, 500), (640, 480))
    for i, (h, w) in enumerate(sizes):
        Image.open(io.BytesIO(_jpeg(SEED + 60 + i, h, w))).save(os.path.join(root, f"demo{i}.jpg"))
    model, cfg = _serving_model("legacy", device)
    opts = SimpleNamespace(
        demo_root=root, demo_image_type="jpg", data_type="voc", model_generation="legacy",
        thres=THRESHOLD, demo_vis=True,
    )
    before = _serving_counts()
    t0 = time.time()
    results = demo_mod.demo(model, cfg, opts)
    fps = len(results) / (time.time() - t0)
    rose = [a - b for a, b in zip(_serving_counts(), before)]
    _require(len(results) == len(sizes) and rose[0] > 0 and rose[2] > 0, f"demo: {len(results)} images, launches {rose}")
    for r in results:
        raw = load_image(r["path"])
        h, w = raw.shape[:2]
        canvas, extent = demo_mod.pad_to_bucket(raw)
        det = predict(
            model, cfg, torch.from_numpy(canvas[None]).to(device), torch.from_numpy(extent[None]).to(device), THRESHOLD
        )
        ok = det.valid[0].cpu().numpy()
        boxes = det.boxes[0].cpu().numpy()[ok] * np.array([canvas.shape[1], canvas.shape[0]] * 2, np.float32)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        same = (
            np.array_equal(r["boxes"], boxes)
            and np.array_equal(r["labels"], det.labels[0].cpu().numpy()[ok])
            and np.array_equal(r["scores"], det.scores[0].cpu().numpy()[ok])
        )
        _require(same, f"demo {r['path']}: detections differ from direct predict")
    print(
        f"demo legacy bfloat16: {len(results)} images ({', '.join(f'{h}x{w}' for h, w in sizes)}), "
        f"{fps:.2f} FPS including each canvas's first call, detections equal to direct predict "
        f"({sum(len(r['scores']) for r in results)}), launches RoIPool/align/NMS {rose}",
        flush=True,
    )
    return dict(zip(("roi_pool", "align", "nms"), rose))


ALL_KERNELS = (
    roi_pool_mod.roi_pool_cuda,
    roi_pool_mod.roi_pool_backward_cuda,
    roi_align_mod.multiscale_roi_align_cuda,
    roi_align_mod.multiscale_roi_align_backward_cuda,
    *IOU_KERNELS,
    roi_align_mod.multiscale_roi_align_slots_cuda,
    NMS_KERNEL,
)


# The main paths' kernels: every kernel but the slot-lattice align, whose
# count is never reset after phase 2.
PATH_KERNELS = (*_head_kernels("legacy"), *_head_kernels("fpn"), *IOU_KERNELS, NMS_KERNEL)


def _launch_counts() -> dict:
    return {k.__name__: k.launches for k in ALL_KERNELS}


def _rank_entry(phase: str, rank: int, world: int, backend: str, model_parallel: int, args) -> None:
    """One rank of a multi-process phase: joins the process group (every
    rank on ``cuda:0``), runs ``phase(rank, *args)`` with the kernels'
    counts set to 0, and leaves its result and those counts, or its
    traceback, under ``DIST_DIR``."""
    import traceback

    from faster_rcnn_pytorch_tpu_torch.parallel import mesh

    out = os.path.join(DIST_DIR, f"{phase}.rank{rank}")
    try:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        mesh.init_distributed(
            rank, world, torch.device("cuda", 0),
            init_method=f"file://{os.path.join(DIST_DIR, phase)}.rendezvous",
            model_parallel=model_parallel, backend=backend, timeout_s=300,
        )
        for k in ALL_KERNELS:
            k.launches = 0
        result = globals()[phase](rank, *args)
        torch.cuda.synchronize()
        result["launches"] = _launch_counts()
        torch.save(result, out + ".pt")
        mesh.shutdown()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(phase: str, world: int, backend: str, *args, model_parallel: int = 1,
              timeout: float = 400.0) -> list:
    """``phase`` in ``world`` spawned processes; their results. A rank that
    fails or hangs past ``timeout`` fails the phase (the hung one killed)."""
    import multiprocessing

    os.makedirs(DIST_DIR, exist_ok=True)
    for f in os.listdir(DIST_DIR):
        if f.startswith(phase + "."):
            os.remove(os.path.join(DIST_DIR, f))
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_entry, args=(phase, r, world, backend, model_parallel, args))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(deadline - time.time(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(world):
        err = os.path.join(DIST_DIR, f"{phase}.rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}: {f.read()}")
    _require(
        not hung and not errors and not any(p.exitcode for p in procs),
        f"{phase}: ranks {hung} hung, exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors),
    )
    return [torch.load(os.path.join(DIST_DIR, f"{phase}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _ddp_train(generation: str, dtype_name: str, steps: int, name: str):
    """``steps`` full-width train steps of phase 6 (legacy) or 12 (FPN)
    through ``train_one_epoch`` on this process's layout: the same
    weights, batch, LR and epoch generator. Returns the state, the losses
    and the step times."""
    dtype = set_numerics(dtype_name)
    cfg, labels = _train_setup(generation)
    model = _new_model(generation).to("cuda")
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

    seed = SEED + (4 if generation == "legacy" else 6)
    loader = RepeatedBatch(synthetic_train_batch(CANVAS, seed, labels=labels), steps)
    recorder = LossRecorder()
    opts = SimpleNamespace(seed=SEED, vis_step=1, log_dir=os.path.join(DIST_DIR, "logs"),
                           name=name, keep_checkpoints=1)
    train_one_epoch(state, timed_step, loader, 0, opts, schedule, recorder)
    shutil.rmtree(opts.log_dir, ignore_errors=True)
    return state, step_fn, recorder.losses, timer.times


def phase21_ddp_nccl(rank: int) -> dict:
    """Phase 21 (world 1, NCCL) and phase 24 (the directory backend's
    asynchronous save beside a NCCL group) in one process."""
    import torch.distributed as dist

    from faster_rcnn_pytorch_tpu_torch.utils import checkpoint as ck

    out = {"backend": dist.get_backend()}
    for generation in ("legacy", "fpn"):
        for dtype_name in ("float32", "bfloat16"):
            state, step_fn, losses, times = _ddp_train(generation, dtype_name, DDP_STEPS, "ddp")
            steady = times[DDP_STEPS - 5:]
            out[(generation, dtype_name)] = {
                "losses": losses[:DDP_CHECKED_STEPS],
                "p50_ms": 1000 * float(np.percentile(steady, 50)),
                "img_s": TRAIN_BATCH * len(steady) / sum(steady),
            }
            if generation == "legacy" and dtype_name == "float32":
                out["save"] = _async_save_steps(state, step_fn, ck)
            del state, step_fn
    return out


def _async_save_steps(state, step_fn, ck) -> dict:
    """Phase 24: legacy float32 steps with no save in flight, then an
    asynchronous directory save of the train state and the steps taken
    while it is written; the loaded state must equal the saved one."""
    batch = _to_device(synthetic_train_batch(CANVAS, SEED + 4, labels=(0, NUM_CLASSES - 1)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def step():
        t0 = time.perf_counter()
        step_fn(state, batch, gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    quiet = [step() for _ in range(SAVE_STEPS)][1:]
    saved_model = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_momentum = {i: s["momentum_buffer"].clone() for i, s in state.optimizer.state_dict()["state"].items()}
    path = os.path.join(DIST_DIR, "async_save", "legacy.0.pt")
    t0 = time.perf_counter()
    ck.save_checkpoint(path, state, {"epoch": 0}, backend="orbax", async_save=True)
    call_s = time.perf_counter() - t0
    during = []
    while ck.saving() and len(during) < 40:
        during.append(step())
    ck.wait_for_checkpoints()
    total_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    fresh = _new_model("legacy").to("cuda")
    loaded = init_train_state(fresh, make_optimizer(fresh))
    ck.load_checkpoint(path, loaded)
    same = all(torch.equal(loaded.model.state_dict()[k], v) for k, v in saved_model.items())
    got = loaded.optimizer.state_dict()["state"]
    same = same and got.keys() == saved_momentum.keys() and all(
        torch.equal(got[i]["momentum_buffer"], v) for i, v in saved_momentum.items()
    )
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return {
        "bytes": size, "call_s": call_s, "total_s": total_s, "equal": same,
        "quiet_p50_ms": 1000 * float(np.percentile(quiet, 50)),
        "during_p50_ms": 1000 * float(np.percentile(during, 50)) if during else None,
        "during_steps": len(during),
    }


def check_ddp_nccl() -> dict:
    """Phase 21 (with 24 inside it); returns the child's launch counts."""
    (out,) = run_ranks("phase21_ddp_nccl", 1, "nccl")
    _require(out["backend"] == "nccl", f"phase 21 ran over {out['backend']}")
    for generation in ("legacy", "fpn"):
        for dtype_name in ("float32", "bfloat16"):
            got, want = out[(generation, dtype_name)], SINGLE_PROCESS[(generation, dtype_name)]
            rel = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]
            if dtype_name == "float32":
                # Step 1 starts from the same weights: bit for bit. Its
                # backward's atomics (RoIPool, align) leave the weights apart
                # by rounding run to run (phases 7 and 13's kernel-vs-kernel
                # spread), in one process as under DDP, and the steps after
                # it amplify that: up to 1.9e-5 relative at step 3 between
                # runs on an H100, so steps 2-3 are held within 1e-4.
                _require(got["losses"][0] == want["losses"][0] and max(rel) <= 1e-4,
                         f"DDP {generation} float32 losses {got['losses']} vs {want['losses']}")
            print(
                f"ddp nccl world 1 {generation} {dtype_name}: losses of steps 1-{DDP_CHECKED_STEPS} "
                f"against the single process's: relative differences "
                f"{', '.join(f'{r:.2g}' for r in rel)}; "
                f"{got['img_s']:.2f} img/s (step p50 {got['p50_ms']:.1f} ms) against "
                f"{want['img_s']:.2f} img/s ({want['p50_ms']:.1f} ms) in one process",
                flush=True,
            )
    save = out["save"]
    _require(save["equal"], "the state loaded from the asynchronous save differs from the saved one")
    _require(save["during_steps"] > 0, "no step ran while the asynchronous save was in flight")
    print(
        f"async directory save of the legacy train state ({save['bytes'] / 1e9:.2f} GB) beside a "
        f"NCCL group: call {save['call_s']:.3f} s, written in {save['total_s']:.2f} s; step p50 "
        f"{save['during_p50_ms']:.1f} ms over {save['during_steps']} steps while in flight against "
        f"{save['quiet_p50_ms']:.1f} ms with none; loaded state identical",
        flush=True,
    )
    return out["launches"]


def _step_reference(model, cfg, batch, seed: int) -> tuple[dict, dict]:
    """One float32 ``make_train_step`` step of ``model`` in this process
    (metrics, gradients on the CPU)."""
    state = init_train_state(model, make_optimizer(model))
    step_fn = make_train_step(cfg, make_lr_schedule("constant", TRAIN_LR, 1, TRAIN_STEPS))
    metrics = step_fn(state, batch, torch.Generator(device="cuda").manual_seed(seed))
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def _gate(name: str, generation: str) -> float:
    return 2e-4 if generation == "legacy" and name.startswith("extractor.") else 1e-5


def phase22_gloo(rank: int, refs: dict, eval_want: dict | None) -> dict:
    """Phase 22 in one rank: the legacy float32 step on this rank's rows
    (one image a rank at data 2; both images, fc6/fc7 split, at model 2),
    its gradients held against each of ``refs`` (name -> a one-process
    gradient file) on rank 0, and with ``eval_want`` the VOC eval of 8
    images at one image a rank."""
    import hashlib

    from faster_rcnn_pytorch_tpu_torch.parallel import tensor_parallel as tp
    from faster_rcnn_pytorch_tpu_torch.parallel.mesh import layout

    set_numerics("float32")
    lay = layout()
    full = _to_device(synthetic_train_batch(CANVAS, SEED + 2), "cuda")
    b = TRAIN_BATCH // lay.data_size
    batch = {k: v[lay.data_rank * b:(lay.data_rank + 1) * b] for k, v in full.items()}
    model = tp.apply_tensor_parallel(_new_model(), lay.model_group, lay.model_rank, lay.model_parallel)
    model = model.to("cuda")
    metrics, grads = _step_reference(model, LEGACY_CONFIG, batch, SEED)
    out = {"metrics": metrics, "digests": {
        n: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
        for n, p in model.named_parameters()
    }}
    grads = tp.gather_state_dict(model, lay.model_group, state={n: g.cuda() for n, g in grads.items()})
    if rank == 0:
        out["grad_errors"] = {}
        for name, path in refs.items():
            want = torch.load(path, weights_only=True)
            out["grad_errors"][name] = {
                n: float((g.cpu() - want[n]).abs().max() / want[n].abs().max().clamp(min=1e-30))
                for n, g in grads.items()
            }
    del model, grads
    if eval_want is not None:
        model = prepare_for_inference(_new_model(), torch.device("cuda"), torch.float32)
        result = evaluate(model, LEGACY_CONFIG, SyntheticImages(N_IMAGES, CANVAS, SEED, batch_size=2),
                          score_threshold=THRESHOLD, verbose=False)
        out["eval_equal"] = _detections_equal(result["detections"], eval_want["detections"])
        out["eval_map"] = result["map"]
    return out


def _per_image_grads(batch: dict) -> dict:
    """One process's gradients of the two-image batch's loss taken an
    image at a time, each image's terms over the batch's counts: what two
    data-parallel ranks sum, with the cuDNN and cuBLAS algorithms of a
    batch of one."""
    model = _new_model().to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = draw_train_noise(gen, TRAIN_BATCH, model.canvas_anchors(*CANVAS).shape[0],
                             LEGACY_CONFIG.post_nms_train + MAX_GT, "cuda")
    counts = []
    forward_train(model, LEGACY_CONFIG, *(batch[k] for k in BATCH_KEYS), noise=noise,
                  count_reduce=lambda c: (counts.append(c) or c, 1))
    model.zero_grad(set_to_none=True)
    for i in range(TRAIN_BATCH):
        out = forward_train(
            model, LEGACY_CONFIG, *(batch[k][i:i + 1] for k in BATCH_KEYS),
            noise=type(noise)(*(t[i:i + 1] for t in noise)), count_reduce=lambda c: (counts[0], 1),
        )
        out.losses.total.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


class _SplitFC(torch.nn.Module):
    """fc6/fc7 of one process computed with the products of phase 22's
    two model ranks: fc6 as two column halves, fc7 as the sum of two
    row-half products (in rank order), then its bias; the weights stay
    whole, so the gradients are in the one-process layout."""

    def __init__(self, classifier):
        super().__init__()
        self.fc6, self.fc7 = classifier[0], classifier[2]

    def forward(self, x):
        halves = zip(self.fc6.weight.chunk(2, 0), self.fc6.bias.chunk(2, 0))
        h = [torch.relu(torch.nn.functional.linear(x, w.contiguous(), b.contiguous())) for w, b in halves]
        w7 = [w.contiguous() for w in self.fc7.weight.chunk(2, 1)]
        y = torch.nn.functional.linear(h[0], w7[0]) + torch.nn.functional.linear(h[1], w7[1])
        return torch.relu(y + self.fc7.bias)


def _split_fc_grads(batch: dict) -> dict:
    """One process's gradients of the two-image step with fc6/fc7 as
    :class:`_SplitFC` computes them."""
    model = _new_model().to("cuda")
    model.classifier = model.fast_rcnn_head.classifier = _SplitFC(model.classifier)
    _step_reference(model, LEGACY_CONFIG, batch, SEED)
    return {n.replace("fc6", "0").replace("fc7", "2"): p.grad.detach().cpu()
            for n, p in model.named_parameters()}


def check_two_ranks_gloo() -> list[dict]:
    """Phase 22: two ranks on the one card over gloo (``backend="gloo"``
    named here; CUDA tensors go through gloo's own collectives), DP and
    TP legacy steps against one process's, and the VOC eval at world 2
    against one process's at batch 1. cuDNN and cuBLAS round a product
    by its shape, and a rounding change flips near-zero ReLUs after fc6
    and near-tied pools (1e-3 of max|g| at conv1 and fc6/fc7, in one
    process on an H100). So each layout's gradients are gated against one
    process computing the same shapes (DP: an image at a time with the
    batch's counts; TP: fc6/fc7 as the two ranks' halves,
    :class:`_SplitFC`), and their distance to the plain two-image step
    is printed. Returns the ranks' launch counts."""
    set_numerics("float32")
    full = _to_device(synthetic_train_batch(CANVAS, SEED + 2), "cuda")
    os.makedirs(DIST_DIR, exist_ok=True)
    model = _new_model().to("cuda")
    want_metrics, grads = _step_reference(model, LEGACY_CONFIG, full, SEED)
    del model
    refs = {name: os.path.join(DIST_DIR, f"phase22_{name}.pt")
            for name in ("batch", "per_image", "split_fc")}
    torch.save(grads, refs["batch"])
    torch.save(_per_image_grads(full), refs["per_image"])
    torch.save(_split_fc_grads(full), refs["split_fc"])
    del grads
    eval_model = prepare_for_inference(_new_model(), torch.device("cuda"), torch.float32)
    eval_want = evaluate(eval_model, LEGACY_CONFIG, SyntheticImages(N_IMAGES, CANVAS, SEED),
                         score_threshold=THRESHOLD, verbose=False)
    del eval_model
    torch.cuda.empty_cache()
    eval_want = {"detections": eval_want["detections"], "map": eval_want["map"]}
    launches = []
    for label, args, mp, gated in (
        ("data 2 x model 1", ({k: refs[k] for k in ("batch", "per_image")}, eval_want), 1, "per_image"),
        ("data 1 x model 2", ({k: refs[k] for k in ("batch", "split_fc")}, None), 2, "split_fc"),
    ):
        outs = run_ranks("phase22_gloo", 2, "gloo", *args, model_parallel=mp)
        for key in ("rpn_cls", "rpn_reg", "roi_cls", "roi_reg"):
            got, want = outs[0]["metrics"][key], want_metrics[key]
            _require(abs(got - want) <= 1e-5 * abs(want), f"{label} {key}: {got} vs {want}")
        notes = []
        for name, errs in outs[0]["grad_errors"].items():
            worst, over = {}, []
            for param, rel in errs.items():
                kind = "backbone" if param.startswith("extractor.") else "rpn+head"
                worst[kind] = max(worst.get(kind, 0.0), rel)
                if rel > _gate(param, "legacy"):
                    over.append(f"{param} {rel:.2g}")
            _require(name != gated or not over, f"{label} vs {name}: over the gate: {over}")
            notes.append(
                f"vs one process {name.replace('_', ' ')} max|d| / max|g| "
                + ", ".join(f"{k} {v:.2g}" for k, v in worst.items())
                + (" (gated)" if name == gated else f" ({len(over)} tensors over the gate)")
            )
        a, b = (o["digests"] for o in outs)
        split = {n for n in a if n.startswith("classifier.") and n != "classifier.2.bias"} if mp > 1 else set()
        differ = [n for n in a if n not in split and a[n] != b[n]]
        _require(not differ, f"{label}: replicas differ after the step: {differ[:4]}")
        print(
            f"gloo on cuda:0, 2 ranks, {label}, legacy float32 step: losses within 1e-5 of one "
            f"process's; {'; '.join(notes)}; replicas identical",
            flush=True,
        )
        if "eval_equal" in outs[0]:
            for o in outs:
                _require(o["eval_equal"], f"{label}: eval detections differ from one process's")
                _require(o["eval_map"] == eval_want["map"], f"{label}: mAP {o['eval_map']} vs {eval_want['map']}")
            print(f"gloo, 2 ranks: VOC eval of {N_IMAGES} images one a rank: detections and mAP "
                  f"({eval_want['map']:.4f}) identical with one process's at batch 1", flush=True)
        launches += [o["launches"] for o in outs]
    for path in refs.values():
        os.remove(path)
    return launches


def check_remat(device) -> None:
    """Phase 23: ``--remat_backbone`` against none, legacy and FPN, float32
    then bfloat16: one step's losses bit for bit and gradients within the
    gate (float32), then peak memory and step p50 over ``REMAT_STEPS``."""
    for generation in ("legacy", "fpn"):
        cfg, labels = _train_setup(generation)
        batch = _to_device(synthetic_train_batch(CANVAS, SEED + 2, labels=labels), device)
        for dtype_name in ("float32", "bfloat16"):
            dtype = set_numerics(dtype_name)
            autocast = dtype if dtype != torch.float32 else None
            runs = {}
            for remat in (False, True):
                model, _ = build_model(generation, FPN_CLASSES if generation == "fpn" else NUM_CLASSES,
                                       remat=remat)
                model = init_weights(model, torch.Generator().manual_seed(SEED)).to(device)
                state = init_train_state(model, make_optimizer(model))
                step_fn = make_train_step(cfg, make_lr_schedule("constant", TRAIN_LR, 1, TRAIN_STEPS),
                                          autocast_dtype=autocast)
                gen = torch.Generator(device=device).manual_seed(SEED)
                metrics = step_fn(state, batch, gen)
                losses = torch.stack([metrics[k] for k in ("rpn_cls", "rpn_reg", "roi_cls", "roi_reg")])
                grads = _grads(model)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(REMAT_STEPS):
                    t0 = time.perf_counter()
                    step_fn(state, batch, gen)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                runs[remat] = (losses, grads, torch.cuda.max_memory_allocated(),
                               1000 * float(np.percentile(times, 50)))
                del state, model, step_fn
                torch.cuda.empty_cache()
            (l0, g0, m0, t0), (l1, g1, m1, t1) = runs[False], runs[True]
            if dtype_name == "float32":
                _require(torch.equal(l0, l1), f"remat {generation}: losses {l1.tolist()} vs {l0.tolist()}")
                for name, g in g0.items():
                    scale = float(g.abs().max())
                    rel = float((g1[name] - g).abs().max()) / scale if scale else float((g1[name] != g).any())
                    _require(rel <= _gate(name, generation), f"remat {generation} {name}: {rel}")
            print(
                f"remat {generation} {dtype_name} {CANVAS[0]}x{CANVAS[1]} batch {TRAIN_BATCH}: peak "
                f"{m1 / 2**30:.2f} GiB against {m0 / 2**30:.2f} without, step p50 {t1:.1f} ms against "
                f"{t0:.1f}; losses {'identical' if torch.equal(l0, l1) else 'differ'}",
                flush=True,
            )


PRETRAINED_DIR = os.path.join(BUILD, "chip_smoke_pretrained")  # phase 25's FRT_CACHE_DIR
PRETRAINED_STEPS = 3  # phase 25's float32 train steps a generation
PRETRAINED_SEED = SEED + 25  # the staged files' weights; the fresh init keeps SEED


def _seeded_like(shapes: dict, seed: int) -> dict:
    """Seeded tensors of ``shapes`` (name -> shape), in torchvision's
    naming: conv weights He-normal (a bottleneck's last conv at 0.25 and
    its downsample at 0.7 of it, as ``FPNFRCNN.init_stds``), biases and
    FrozenBN statistics small and non-trivial, linear layers N(0, 0.01)."""
    g = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[1]
        if len(shape) == 4:
            gain = 0.25 if name.endswith("conv3.weight") else 0.7 if "downsample.0" in name else 1.0
            out[name] = torch.randn(shape, generator=g) * gain * (2.0 / float(np.prod(shape[1:]))) ** 0.5
        elif len(shape) == 2:
            out[name] = torch.randn(shape, generator=g) * 0.01
        elif leaf == "running_var":
            out[name] = uniform(shape, 0.5, 1.5)
        elif leaf == "weight":  # a FrozenBN scale
            out[name] = uniform(shape, 0.5, 1.0)
        else:  # conv and linear biases, FrozenBN shifts and means
            out[name] = uniform(shape, -0.1, 0.1)
    return out


def stage_pretrained_files(root: str) -> dict:
    """Phase 25's cache, made from ``PRETRAINED_SEED`` (nothing is
    downloaded): torchvision's ``vgg16-397923af.pth`` (``features.*`` at
    the 13 conv indices and ``classifier.{0,3,6}``), its
    ``resnet50-0676ba61.pth`` (``conv1``, ``bn1``, ``layer1-4`` and
    ``fc``, without ``num_batches_tracked``, as the published file) and
    the reference ``frcnn.best.pth.tar`` of a seeded legacy VOC detector
    written by the port's ``save_torch_checkpoint``. Returns their paths
    by registry name."""
    from faster_rcnn_pytorch_tpu_torch.models.resnet import ResNet50
    from faster_rcnn_pytorch_tpu_torch.models.vgg import VGG16Features
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import save_torch_checkpoint
    from faster_rcnn_pytorch_tpu_torch.utils.pretrained import CHECKPOINTS

    cache = os.path.join(root, "checkpoints")
    os.makedirs(cache, exist_ok=True)
    paths = {name: os.path.join(cache, CHECKPOINTS[name][1]) for name in ("vgg16", "resnet50", "frcnn_demo")}
    with torch.device("meta"):
        vgg = {f"features.{k}": tuple(v.shape) for k, v in VGG16Features().state_dict().items()}
        body = {k: tuple(v.shape) for k, v in ResNet50().state_dict().items()
                if not k.endswith("num_batches_tracked")}
    vgg.update({"classifier.0.weight": (4096, 512 * 7 * 7), "classifier.0.bias": (4096,),
                "classifier.3.weight": (4096, 4096), "classifier.3.bias": (4096,),
                "classifier.6.weight": (1000, 4096), "classifier.6.bias": (1000,)})
    body.update({"fc.weight": (1000, 2048), "fc.bias": (1000,)})
    torch.save(_seeded_like(vgg, PRETRAINED_SEED), paths["vgg16"])
    torch.save(_seeded_like(body, PRETRAINED_SEED + 1), paths["resnet50"])
    detector, _ = build_model("legacy", NUM_CLASSES)
    save_torch_checkpoint(paths["frcnn_demo"], init_weights(detector, torch.Generator().manual_seed(PRETRAINED_SEED)))
    return paths


def check_pretrained(device) -> dict:
    """Phase 25: the weight flags through the functions the CLIs call, on
    files staged in a ``FRT_CACHE_DIR`` of its own. (a) ``--pretrained_backbone
    auto``, both generations, through ``utils.checkpoint.init_params``
    (``main``'s call): the backbone on the card equals the staged file bit
    for bit and every other tensor the seeded fresh init; then float32
    train steps, each launching the head's forward and backward kernels
    and the NMS kernel once, with finite losses. (b) ``--checkpoint
    pretrained`` through ``load_detector`` (``demo`` and ``export``)
    against the same file by explicit path through
    ``resolve_and_load_params`` (``test``): identical weights, and
    identical float32 detections at 800x1344 with RoIPool and NMS
    launched. Returns the launch counts of the phase."""
    from faster_rcnn_pytorch_tpu_torch.config import load_options
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import init_detector_weights
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import (
        init_params,
        load_detector,
        resolve_and_load_params,
    )
    from faster_rcnn_pytorch_tpu_torch.utils.convert import load_reference_checkpoint

    t0 = time.time()
    saved = os.environ.get("FRT_CACHE_DIR")
    shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
    os.environ["FRT_CACHE_DIR"] = PRETRAINED_DIR
    total = dict.fromkeys(_launch_counts(), 0)  # the slot-lattice align's stays 0
    try:
        paths = stage_pretrained_files(PRETRAINED_DIR)
        set_numerics("float32")
        for generation, name, prefix, source in (
            ("legacy", "vgg16", "extractor.", "features."),
            ("fpn", "resnet50", "backbone.body.", ""),
        ):
            argv = ["--pretrained_backbone", "auto", "--model_generation", generation]
            if generation == "fpn":
                argv += ["--data_type", "coco", "--num_classes", str(FPN_CLASSES)]
            opts = load_options(argv)
            model, _ = build_model(generation, opts.num_classes)
            note = init_params(model, opts)
            _require(opts.pretrained_backbone == paths[name], f"auto resolved to {opts.pretrained_backbone}")
            model = model.to(device)
            staged = load_reference_checkpoint(paths[name])
            fresh, _ = build_model(generation, opts.num_classes)
            fresh = init_detector_weights(fresh, torch.Generator().manual_seed(opts.seed)).state_dict()
            n_file = 0
            for k, v in model.state_dict().items():
                if k.startswith(prefix) and not k.endswith("num_batches_tracked"):
                    n_file += 1
                    _require(torch.equal(v, staged[source + k[len(prefix):]].to(device)), f"{k} is not the file's")
                else:
                    _require(torch.equal(v.cpu(), fresh[k]), f"{k} is not the CLI's fresh init")
            _require(n_file == (26 if generation == "legacy" else 265), f"{n_file} tensors from the file")
            cfg, labels = _train_setup(generation)
            batch = synthetic_train_batch(CANVAS, PRETRAINED_SEED, labels=labels)
            counts, losses, timer, _ = train_epoch(model, cfg, batch, PRETRAINED_STEPS, f"pretrained_{generation}")
            fwd, bwd = _head_kernels(generation)
            for k in (fwd, bwd, NMS_KERNEL):
                _require(counts[k.__name__] == PRETRAINED_STEPS,
                         f"pretrained {generation} train: {counts[k.__name__]} launches of {k.__name__}")
            _require(bool(np.isfinite(losses).all()) and len(losses) == PRETRAINED_STEPS,
                     f"pretrained {generation} train losses {losses}")
            for k, v in counts.items():
                total[k] += v
            print(
                f"pretrained {generation}: {note}; {n_file} backbone tensors equal the file bit for bit on "
                f"the card, the rest the seeded init; {PRETRAINED_STEPS} float32 train steps at "
                f"{CANVAS[0]}x{CANVAS[1]} batch {TRAIN_BATCH}: step p50 {1000 * timer.p50():.1f} ms, losses "
                f"{[round(x, 4) for x in losses]}, launches {counts}",
                flush=True,
            )
            del model, staged, fresh

        by_name = load_options(["--checkpoint", "pretrained", "--log_dir", LOG_DIR])
        model_a, _, note_a = load_detector(by_name)
        _require(by_name.checkpoint == paths["frcnn_demo"], f"pretrained resolved to {by_name.checkpoint}")
        by_path = load_options(["--checkpoint", paths["frcnn_demo"], "--log_dir", LOG_DIR])
        model_b, _ = build_model("legacy", NUM_CLASSES)
        note_b = resolve_and_load_params(by_path, model_b)
        want = load_reference_checkpoint(paths["frcnn_demo"])
        for k, v in model_a.state_dict().items():
            _require(torch.equal(v, want[k]) and torch.equal(model_b.state_dict()[k], want[k]), f"{k} differs")
        results = []
        for model in (model_a, model_b):
            for k in PATH_KERNELS:
                k.launches = 0
            result, counts = run_predict(model, "float32", device, SyntheticImages(N_IMAGES, CANVAS, PRETRAINED_SEED))
            launches = {k.__name__: k.launches for k in PATH_KERNELS}
            _require(launches[roi_pool_mod.roi_pool_cuda.__name__] > 0, "pretrained predict: no RoIPool launch")
            _require(launches[NMS_KERNEL.__name__] == 2 * N_IMAGES, f"pretrained predict: {launches}")
            _require(sum(counts) > 0, "pretrained predict found no detections to compare")
            for k, v in launches.items():
                total[k] += v
            results.append(result["detections"])
        _require(_detections_equal(*results), "--checkpoint pretrained and the explicit path detect differently")
        print(
            f"pretrained detector: {note_a} (demo/export) and {note_b} (test): identical weights and float32 "
            f"detections at {CANVAS[0]}x{CANVAS[1]}; phase 25 took {time.time() - t0:.1f} s wall",
            flush=True,
        )
    finally:
        if saved is None:
            os.environ.pop("FRT_CACHE_DIR", None)
        else:
            os.environ["FRT_CACHE_DIR"] = saved
        shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
    _require_slots_idle("phase 25")
    return total


PREFLIGHT_DIR = os.path.join(BUILD, "chip_smoke_preflight")  # phase 26's trees, checkpoint, drawing
PREFLIGHT_LIMIT = 20  # FRT_PREFLIGHT_LIMIT, the drill's default
PREFLIGHT_SEED = SEED + 26  # the checkpoint's weights and the tutorial's JPEG
TUTORIAL_CLASS = 15  # the class head's one live output in the tutorial script's checkpoint
TUTORIAL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "tutorial_torch.py")


def _run_drill(argv: list[str]) -> tuple[dict, dict]:
    """The drill's ``main(argv)`` in this process under
    ``FRT_PREFLIGHT_LIMIT``, the kernels' counts reset just before and read
    just after. Returns its JSON reports by name (``layout``,
    ``checkpoint``, ``mini eval``, plus its eval ``img/s``) and the
    counts. Its output is printed after it."""
    from faster_rcnn_pytorch_tpu_torch.tools import preflight_real_data as drill

    saved = os.environ.get(drill.LIMIT_ENV)
    os.environ[drill.LIMIT_ENV] = str(PREFLIGHT_LIMIT)
    out = io.StringIO()
    for k in PATH_KERNELS:
        k.launches = 0
    try:
        with contextlib.redirect_stdout(out):
            rc = drill.main(argv)
    finally:
        counts = {k.__name__: k.launches for k in PATH_KERNELS}
        if saved is None:
            os.environ.pop(drill.LIMIT_ENV)
        else:
            os.environ[drill.LIMIT_ENV] = saved
        print(out.getvalue(), end="", flush=True)
    _require(rc == 0, f"the drill {argv} returned {rc}")
    text = out.getvalue()
    reports = {
        m.group(1): json.loads(m.group(2))
        for m in re.finditer(r"^\[preflight\] (layout|checkpoint|mini eval) ok: (\{.*\})$", text, re.M)
    }
    speed = re.search(r"eval inference: \d+ images in [\d.]+s \(([\d.]+) img/s\)", text)
    _require(speed and {"layout", "mini eval"} <= reports.keys(), f"the drill printed:\n{text}")
    reports["img/s"] = float(speed.group(1))
    return reports, counts


def _load_tutorial():
    import importlib.util

    spec = importlib.util.spec_from_file_location("tutorial_torch", TUTORIAL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_preflight_and_tutorial(device, card: str) -> dict:
    """Phase 26: the real-data drill
    (``faster_rcnn_pytorch_tpu_torch/tools/preflight_real_data.py``) and
    the single-image tutorial (``examples/tutorial_torch.py``) on
    generated trees under ``PREFLIGHT_DIR`` (removed after). (a) Legacy on
    VOC (``tools/make_shapes_voc.py``, 8 train and 24 test scenes) with a
    seeded ``frcnn.best.pth.tar`` at the default ``--resize 800``, in
    float32 (TF32 off) and bfloat16: the census's ``params`` is the
    model's, RoIPool and NMS (twice a predict call) launched, the align
    and IoU kernels never, ``PREFLIGHT_LIMIT`` images taken; in float32
    the drill's detections are those of the first ``PREFLIGHT_LIMIT``
    images of one unbounded eval of the 24, bit for bit. (b) FPN on COCO
    (``tools/make_shapes_coco.py``, 4 and 24) with the seeded fresh init,
    bfloat16: both splits counted, the align kernel and NMS launched,
    RoIPool never. (c) The tutorial's functions on a seeded JPEG with
    (a)'s checkpoint, in its bfloat16, at ``THRESHOLD``: its detections
    equal direct ``predict`` on its canvas with the same weights and
    dtype, RoIPool and NMS launched; then ``python
    examples/tutorial_torch.py <jpeg> <ckpt>`` (at its own 0.5), the
    checkpoint's class head made constant (``TUTORIAL_CLASS``), exits 0,
    prints its detections, more than none, and draws them into
    ``tutorial_out.png``. Returns the launch counts of the drills and the
    tutorial's in-process call."""
    from faster_rcnn_pytorch_tpu_torch.config import load_options
    from faster_rcnn_pytorch_tpu_torch.tools import preflight_real_data as drill
    from faster_rcnn_pytorch_tpu_torch.tools import shapes_recipe
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import save_torch_checkpoint

    t0 = time.time()
    _require(os.environ.get("FRT_TORCH_DEVICE") != "cpu", "FRT_TORCH_DEVICE=cpu would send the drill to the CPU")
    shutil.rmtree(PREFLIGHT_DIR, ignore_errors=True)
    voc, coco = os.path.join(PREFLIGHT_DIR, "voc"), os.path.join(PREFLIGHT_DIR, "coco")
    logs = os.path.join(PREFLIGHT_DIR, "logs")  # no checkpoint there: (b) takes the fresh init
    ckpt = os.path.join(PREFLIGHT_DIR, "frcnn.best.pth.tar")
    total = dict.fromkeys(_launch_counts(), 0)
    pool, align, nms = (
        k.__name__ for k in (roi_pool_mod.roi_pool_cuda, roi_align_mod.multiscale_roi_align_cuda, NMS_KERNEL)
    )
    try:
        shapes_recipe.make_data(voc, 8, 24)
        shapes_recipe.make_data(coco, 4, 24, data="coco")
        model, _ = build_model("legacy", NUM_CLASSES)
        # He-init heads: class scores past the threshold, so the detections compared are not empty
        save_torch_checkpoint(ckpt, init_weights(model, torch.Generator().manual_seed(PREFLIGHT_SEED)))
        n_params = sum(p.numel() for p in model.parameters())

        voc_argv = ["--data_type", "voc", "--data_root", voc, "--checkpoint", ckpt, "--log_dir", logs]
        speeds = {}
        dump = os.path.join(PREFLIGHT_DIR, "drill.pkl")
        for dtype_name in ("float32", "bfloat16"):
            reports, counts = _run_drill(voc_argv + ["--dtype", dtype_name, "--dump_detections", dump])
            census, mini = reports["checkpoint"], reports["mini eval"]
            _require(census["params"] == n_params and census["torch_keys"] == len(model.state_dict()),
                     f"census {census}: the model has {n_params} parameters in {len(model.state_dict())} tensors")
            _require(mini["images"] == PREFLIGHT_LIMIT, f"the {dtype_name} drill took {mini['images']} images")
            _require(counts[pool] > 0 and counts[nms] == 2 * PREFLIGHT_LIMIT, f"{dtype_name} drill: {counts}")
            _require(counts[align] == 0 and not any(counts[k.__name__] for k in IOU_KERNELS),
                     f"{dtype_name} drill: {counts}")
            speeds[f"legacy VOC {dtype_name}"] = reports["img/s"]
            for k, n in counts.items():
                total[k] += n
            if dtype_name == "float32":
                with open(dump, "rb") as f:
                    got = pickle.load(f)["predictions"]
                # max_images=0 evaluates every image: the same path, unbounded
                full = drill.run_mini_eval(load_options(voc_argv + ["--dtype", "float32"]), 0)["detections"]
                first = list(full)[:PREFLIGHT_LIMIT]
                _require(len(full) == 24 and list(got) == first, f"the drill took {list(got)}, not {first}")
                _require(_detections_equal(got, {i: full[i] for i in first}),
                         "the drill's float32 detections differ from the unbounded eval's first images")
                n_det = sum(len(d["scores"]) for d in got.values())
                _require(n_det > 0, "the float32 drill found no detections to compare")
                print(f"phase 26: float32 drill == the first {PREFLIGHT_LIMIT} of 24 images bit for bit "
                      f"({n_det} detections)", flush=True)

        reports, counts = _run_drill([
            "--data_type", "coco", "--model_generation", "fpn", "--num_classes", str(FPN_CLASSES),
            "--data_root", coco, "--dtype", "bfloat16", "--log_dir", logs,
        ])
        layout = reports["layout"]
        _require(layout["train2017"]["images"] == 4 and layout["val2017"]["images"] == 24, f"layout {layout}")
        _require(reports["mini eval"]["images"] == PREFLIGHT_LIMIT, f"FPN drill: {reports['mini eval']}")
        _require(counts[align] > 0 and counts[nms] > 0 and counts[pool] == 0, f"FPN drill: {counts}")
        speeds["FPN COCO bfloat16"] = reports["img/s"]
        for k, n in counts.items():
            total[k] += n

        tutorial = _load_tutorial()
        # This module instance only: the tutorial's 0.5 keeps none of a random head's scores.
        tutorial.THRESHOLD = THRESHOLD
        jpeg = os.path.join(PREFLIGHT_DIR, "tutorial.jpg")
        with open(jpeg, "wb") as f:
            f.write(_jpeg(PREFLIGHT_SEED, 375, 500))
        dtype = set_numerics(tutorial.DTYPE)
        model, cfg = tutorial.load_model(ckpt)
        model = prepare_for_inference(model, device, dtype)
        raw = load_image(jpeg)
        for k in PATH_KERNELS:
            k.launches = 0
        boxes, labels, scores = tutorial.detect_image(model, cfg, raw)
        counts = {k.__name__: k.launches for k in PATH_KERNELS}
        _require(counts[pool] > 0 and counts[nms] == 2, f"tutorial: {counts}")
        _require(len(scores) > 0, "the tutorial found no detections to compare")
        for k, n in counts.items():
            total[k] += n
        canvas, extent, (h, w) = tutorial.to_canvas(raw)
        det = predict(model, cfg, torch.from_numpy(canvas[None]).to(device),
                      torch.from_numpy(extent[None]).to(device), tutorial.THRESHOLD)
        valid = det.valid[0].cpu().numpy()
        (ch, cw), (oh, ow) = canvas.shape[:2], raw.shape[:2]
        want = det.boxes[0].float().cpu().numpy()[valid] * np.array([cw, ch, cw, ch])
        want = want / np.array([w, h, w, h]) * np.array([ow, oh, ow, oh])
        _require(np.array_equal(boxes, want) and np.array_equal(labels, det.labels[0].cpu().numpy()[valid])
                 and np.array_equal(scores, det.scores[0].float().cpu().numpy()[valid]),
                 "the tutorial's detections differ from direct predict on its canvas")
        # The script keeps its own 0.5, which no score of the He-init head reaches. Its
        # checkpoint gets a constant class head, every roi TUTORIAL_CLASS at ~1.0, so that
        # the script finds detections and draws their boxes.
        head, _ = tutorial.load_model(ckpt)
        with torch.no_grad():
            head.fast_rcnn_head.cls_head.weight.zero_()
            head.fast_rcnn_head.cls_head.bias.zero_()
            head.fast_rcnn_head.cls_head.bias[TUTORIAL_CLASS] = 10.0
        save_torch_checkpoint(ckpt, head)
        del head
        proc = subprocess.run(
            [sys.executable, TUTORIAL, jpeg, ckpt], cwd=PREFLIGHT_DIR, capture_output=True, text=True, timeout=600
        )
        drawn = os.path.join(PREFLIGHT_DIR, "tutorial_out.png")
        _require(proc.returncode == 0 and os.path.exists(drawn),
                 f"tutorial_torch.py exit {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        said = re.search(r"^(\d+) detections$", proc.stdout, re.M)
        _require(said and int(said.group(1)) > 0, f"tutorial_torch.py printed:\n{proc.stdout[-2000:]}")
        picture = load_image(drawn)
        _require(picture.shape == raw.shape and (picture != raw).any(),
                 f"tutorial_out.png {picture.shape} holds no box over the {raw.shape} image")
        print(
            f"phase 26: tutorial {tutorial.DTYPE} {ch}x{cw} canvas of a {oh}x{ow} JPEG: {len(scores)} "
            f"detections at {tutorial.THRESHOLD} == direct predict, launches {counts}; as a subprocess "
            f"with a constant class head, {said.group(1)} detections at 0.5 drawn, "
            f"{os.path.getsize(drawn)} B tutorial_out.png",
            flush=True,
        )
    finally:
        shutil.rmtree(PREFLIGHT_DIR, ignore_errors=True)
    _require_slots_idle("phase 26")
    print(
        f"phase 26 took {time.time() - t0:.1f} s wall; drill eval img/s "
        f"{', '.join(f'{k} {v}' for k, v in speeds.items())}; launches {total} ({card})",
        flush=True,
    )
    return total


def check_fpn_dense(device) -> dict:
    """Phase 27: phases 15 and 16 for the FPN generation, gt padded to
    ``FPN_DENSE_MAX_GT`` (640) slots. Returns the launches of its 20-step
    runs (the main path's: neither the stage split nor the comparison with
    the plain version counts)."""
    counts = {k.__name__: 0 for k in ALL_KERNELS}
    fwd_k, bwd_k = _head_kernels("fpn")
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, iou, nms = run_train(dtype_name, device, "fpn", dense=True)
        for k, n in ((fwd_k, fwd), (bwd_k, bwd), (boxes_mod.iou_match_cuda, iou), (NMS_KERNEL, nms)):
            counts[k.__name__] += n
    check_dense_targets_kernel_vs_plain(device, "fpn")
    return counts


SHAPES_DIR = os.path.join(BUILD, "chip_smoke_shapes")  # phase 28's scenes, logs and checkpoints
SHAPES_EPOCHS = 8
SHAPES_MIN_AP50 = 0.55  # the best epoch's; an untrained detector reads under 0.1
SHAPES_MAX_DMAP = 0.01  # float32 against bfloat16 test-CLI mAP of the best checkpoint


def check_shapes_voc(device) -> dict:
    """Phase 28: both generations trained from random init through the
    port's ``main`` (in this process) on ``tools/make_shapes_voc.py``
    scenes (800 train, 160 test, 3 classes, 320 px; a subprocess, under
    ``SHAPES_DIR``, removed after), the recipe of ``ACCURACY_SHAPES.json``
    (``tools/shapes_recipe.py``) for ``SHAPES_EPOCHS`` epochs, cuDNN in its
    CLI defaults; then the best checkpoint through the port's ``test`` CLI
    at ``--dtype float32`` (TF32 off) and ``bfloat16`` on 800 test scenes
    of the same generator (``shapes_recipe.N_CHECK``). Gates: every logged
    loss finite; the head's forward and backward kernels and NMS launched
    at least once a step; best AP50 >= ``SHAPES_MIN_AP50``; the two test
    mAPs within ``SHAPES_MAX_DMAP``. Returns the launches of the main and
    test runs, counts reset just before and read just after."""
    from faster_rcnn_pytorch_tpu_torch.tools import shapes_recipe

    t0 = time.time()
    _require(os.environ.get("FRT_TORCH_DEVICE") != "cpu", "FRT_TORCH_DEVICE=cpu would send main to the CPU")
    shutil.rmtree(SHAPES_DIR, ignore_errors=True)
    root, logs = os.path.join(SHAPES_DIR, "voc"), os.path.join(SHAPES_DIR, "logs")
    check_root = os.path.join(SHAPES_DIR, "check")
    shapes_recipe.make_data(root)
    shapes_recipe.make_check_data(check_root)
    steps = shapes_recipe.steps_per_epoch(root)
    print(f"phase 28: {steps} steps an epoch, data made in {time.time() - t0:.1f} s", flush=True)
    total = {k.__name__: 0 for k in ALL_KERNELS}
    deterministic = torch.backends.cudnn.deterministic
    for generation in ("legacy", "fpn"):
        t1 = time.time()
        name = f"shapes_{generation}"
        argv = shapes_recipe.recipe_argv(
            generation, root, SHAPES_EPOCHS, "--log_dir", logs, "--name", name, "--vis_step", "10",
            "--keep_checkpoints", "1",
        )
        for k in PATH_KERNELS:
            k.launches = 0
        torch.backends.cudnn.deterministic = False  # as the CLI runs
        try:
            run = shapes_recipe.run_in_process(argv, steps)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        t_train = time.time() - t1
        maps, pairing = shapes_recipe.test_best(generation, check_root, logs, name)
        counts = {k.__name__: k.launches for k in PATH_KERNELS}
        n_steps = steps * SHAPES_EPOCHS
        _require(run["epochs"] == list(range(SHAPES_EPOCHS)), f"{name}: epochs {run['epochs']} logged")
        _require(run["losses_finite"] and run["losses_logged"] >= n_steps // 10, f"{name}: losses {run}")
        for k in (*_head_kernels(generation), NMS_KERNEL):
            _require(counts[k.__name__] >= n_steps, f"{name}: {k.__name__} {counts[k.__name__]} < {n_steps} steps")
        other = _head_kernels("fpn" if generation == "legacy" else "legacy")
        _require(not any(counts[k.__name__] for k in other), f"{name} launched the other head's kernels: {counts}")
        _require(run["best_map"] >= SHAPES_MIN_AP50, f"{name}: best AP50 {run['best_map']} < {SHAPES_MIN_AP50}")
        d_map = maps["bfloat16"] - maps["float32"]
        _require(abs(d_map) <= SHAPES_MAX_DMAP, f"{name}: test mAP {maps}")
        _require_slots_idle(f"phase 28 {generation}")
        for k, n in counts.items():
            total[k] += n
        record = shapes_recipe.jax_record("voc", generation, SHAPES_EPOCHS)
        print(
            f"phase 28 {generation}: AP50 by epoch, the JAX package's {record['name']} (TPU v5e, its own "
            f"init and seed) {' '.join(f'{v:.4f}' for v in record['map_by_epoch'])} (best "
            f"{record['best_map']:.4f}); this run {' '.join(f'{v:.4f}' for v in run['map_by_epoch'])} "
            f"(best {run['best_map']:.4f})",
            flush=True,
        )
        print(
            f"phase 28 {generation}: AP50 by epoch {' '.join(f'{v:.4f}' for v in run['map_by_epoch'])} "
            f"(best {run['best_map']:.4f}, final {run['final_map']:.4f}); train loop "
            f"{' '.join(f'{v:.1f}' for v in run['train_img_s_by_epoch'])} img/s by epoch (median "
            f"{run['train_img_s_median']:.2f}); epoch wall {' '.join(f'{v:.1f}' for v in run['epoch_wall_s_by_epoch'])} s "
            f"(median {run['epoch_wall_s_median']:.2f}); {run['losses_logged']} logged losses finite; main "
            f"{t_train:.1f} s; test CLI on the best checkpoint, {shapes_recipe.N_CHECK} test scenes: mAP "
            f"float32 {maps['float32']:.4f}, bfloat16 {maps['bfloat16']:.4f} (d {d_map:+.4f}); {pairing}; "
            f"launches {counts}; {time.time() - t1:.1f} s",
            flush=True,
        )
        shutil.rmtree(os.path.join(logs, name))  # the checkpoints (1.1 GB legacy)
    shutil.rmtree(SHAPES_DIR)
    print(f"phase 28 took {time.time() - t0:.1f} s wall", flush=True)
    return total


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
    check_roi_pool_large_maps(device)
    print_roi_pool_plans()
    align_record = check_roi_align_kernel(device)
    align_bwd_record = check_roi_align_backward_kernel(device)
    iou_record = check_iou_kernel(device)
    slots_record = check_roi_align_slots_kernel(device, align_record)
    check_align_footprint_edges(device)
    roi_align_mod.multiscale_roi_align_slots_cuda.launches = 0
    nms_record = check_nms_kernel(device)

    launches = nms_launches = 0
    detections = {}
    for dtype_name in ("float32", "bfloat16"):
        model = _new_model()
        # Warm-up (cuDNN and cuBLAS handles, first launches), outside the counts.
        run_predict(model, dtype_name, device, SyntheticImages(1, CANVAS, SEED))
        loader = SyntheticImages(N_IMAGES, CANVAS, SEED)
        roi_pool_mod.roi_pool_cuda.launches = 0
        NMS_KERNEL.launches = 0
        for k in IOU_KERNELS:
            k.launches = 0
        result, counts = run_predict(model, dtype_name, device, loader)
        count = roi_pool_mod.roi_pool_cuda.launches
        nms = NMS_KERNEL.launches
        _require(count > 0, f"{dtype_name} predict never launched the RoIPool kernel")
        _require(nms == 2 * N_IMAGES, f"{dtype_name} predict: {nms} NMS launches for {N_IMAGES} calls")
        nms_launches += nms
        _require(_iou_launches() == 0, f"{dtype_name} predict launched the IoU kernel")
        _require_slots_idle(f"{dtype_name} predict")
        if dtype_name == "float32":
            _require(sum(counts) > 0, "float32 predict found no detections to compare")
            detections = result["detections"]
        launches += count

    roi_pool_mod.roi_pool_cuda.launches = 0
    NMS_KERNEL.launches = 0
    plain, _ = run_predict(
        _new_model(), "float32", device, SyntheticImages(N_IMAGES, CANVAS, SEED), plain=True
    )
    _require(roi_pool_mod.roi_pool_cuda.launches == 0, "the plain-RoIPool run launched the kernel")
    _require(NMS_KERNEL.launches == 0, "the plain run launched the NMS kernel")
    _require(
        _detections_equal(plain["detections"], detections),
        "float32 detections differ between the kernels and plain RoIPool and NMS",
    )
    print("float32 detections identical with the kernels and with plain RoIPool and NMS", flush=True)

    check_small_input_reference(device)

    bwd_launches = 0
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, _, nms = run_train(dtype_name, device)
        launches += fwd
        bwd_launches += bwd
        nms_launches += nms
    record["launches"] = launches
    bwd_record["launches"] = bwd_launches

    check_train_step_kernel_vs_plain(device)
    check_small_input_train_reference(device)

    align_record["launches"], nms, fpn_detections = run_fpn_predict(device)
    nms_launches += nms
    fpn_loader = _fpn_loader(SEED + 5)
    roi_align_mod.multiscale_roi_align_cuda.launches = 0
    NMS_KERNEL.launches = 0
    plain, _ = run_predict(_new_model("fpn"), "float32", device, fpn_loader, "fpn", plain=True)
    _require(
        roi_align_mod.multiscale_roi_align_cuda.launches == 0, "the plain-align run launched the kernel"
    )
    _require(NMS_KERNEL.launches == 0, "the plain FPN run launched the NMS kernel")
    _require(
        _detections_equal(plain["detections"], fpn_detections),
        "float32 FPN detections differ between the kernels and the plain align and NMS",
    )
    print("float32 FPN detections identical with the kernels and with the plain align and NMS", flush=True)
    check_small_input_reference(device, "fpn", FPN_SMALL_CANVAS)

    align_bwd_record["launches"] = 0
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, _, nms = run_train(dtype_name, device, "fpn")
        align_record["launches"] += fwd
        align_bwd_record["launches"] += bwd
        nms_launches += nms
    check_train_step_kernel_vs_plain(device, "fpn")
    check_small_input_train_reference(device, "fpn", FPN_SMALL_CANVAS)

    iou_record["launches"] = 0
    for dtype_name in ("float32", "bfloat16"):
        fwd, bwd, iou, nms = run_train(dtype_name, device, dense=True)
        record["launches"] += fwd
        bwd_record["launches"] += bwd
        iou_record["launches"] += iou
        nms_launches += nms
    check_dense_targets_kernel_vs_plain(device)
    nms_record["launches"] = nms_launches

    check_sync_free_predict(device)
    fpn_export_dir, exported = run_export(device)
    served = run_serve(device, fpn_export_dir)
    demoed = run_demo(device)
    for rec, key in ((record, "roi_pool"), (align_record, "align"), (nms_record, "nms")):
        rec["serving_launches"] = exported[key] + served[key] + demoed[key]
    slots_record["launches"] = roi_align_mod.multiscale_roi_align_slots_cuda.launches
    _require_slots_idle("the main paths")

    # Phases 21-24, the parallel paths: the ranks' launch counts come back
    # from their processes; the parent's phase 23 counts its own.
    phase21 = check_ddp_nccl()
    for kernel in (*_head_kernels("legacy"), *_head_kernels("fpn"), NMS_KERNEL):
        _require(phase21[kernel.__name__] > 0, f"phase 21 never launched {kernel.__name__}")
    phase22 = check_two_ranks_gloo()
    before = _launch_counts()
    check_remat(device)
    phase23 = {k: v - before[k] for k, v in _launch_counts().items()}
    phase25 = check_pretrained(device)  # resets the counts; returns its own
    phase26 = check_preflight_and_tutorial(device, card)  # likewise
    phase27 = check_fpn_dense(device)
    phase28 = check_shapes_voc(device)
    for counts in (phase21, *phase22, phase23, phase25, phase26, phase27, phase28):
        for rec, kernels in (
            (record, (roi_pool_mod.roi_pool_cuda,)),
            (bwd_record, (roi_pool_mod.roi_pool_backward_cuda,)),
            (align_record, (roi_align_mod.multiscale_roi_align_cuda,)),
            (align_bwd_record, (roi_align_mod.multiscale_roi_align_backward_cuda,)),
            (iou_record, IOU_KERNELS),
            (slots_record, (roi_align_mod.multiscale_roi_align_slots_cuda,)),
            (nms_record, (NMS_KERNEL,)),
        ):
            rec["launches"] += sum(counts[k.__name__] for k in kernels)
    _require(slots_record["launches"] == 0, "a phase after 20 launched the slot-lattice align kernel")
    print(
        f"launches: phase 21 {phase21}; phase 22 {phase22}; phase 23 {phase23}; phase 25 {phase25}; "
        f"phase 26 {phase26}; phase 27 {phase27}; phase 28 {phase28} ({card})",
        flush=True,
    )

    leaked = [m for m in ("jax", "flax") if m in sys.modules]
    _require(not leaked, f"imported {leaked}")

    print(f"chip_smoke: {time.time() - t_start:.1f}s end to end", flush=True)
    print(
        json.dumps(
            {
                "kernels": [
                    record, bwd_record, align_record, align_bwd_record, iou_record, slots_record,
                    nms_record,
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

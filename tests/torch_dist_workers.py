"""Shared set-up of the port's distributed CPU tests, and their ranks.

No jax here: each function below runs in a rank that
``tests/torch_dist.py::run_ranks`` spawns. The set-up is small: both
generations at their full widths with 6 classes on a 192x256 canvas,
with small proposal and sampling budgets (``LEGACY``, ``FPN``), seeded
weights, and a seeded global batch whose second image has a small extent,
so that the boundary filter leaves it fewer than ``rpn_total_quota``
trainable anchors and the two images' loss counts differ (a per-rank mean
would then not be the global mean).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.parallel import train_step as pts
from faster_rcnn_pytorch_tpu_torch.parallel.mesh import layout
from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics

CANVAS = (192, 256)
NUM_CLASSES = 6
LEGACY = dataclasses.replace(
    pfr.LEGACY_CONFIG, num_classes=NUM_CLASSES, pre_nms_train=256, post_nms_train=64,
    roi_samples=16, roi_pos_quota=4,
)
FPN = dataclasses.replace(
    pfr.FPN_CONFIG, num_classes=NUM_CLASSES, pre_nms_train=256, post_nms_train=64,
    roi_samples=32, roi_pos_quota=8,
)
CONFIGS = {"legacy": LEGACY, "fpn": FPN}
KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")
LR = 1e-3


def make_batch(b: int, seed: int = 0, g: int = 4, generation: str = "legacy") -> dict:
    """``b`` images; odd ones have the small extent (0.7, 0.75). The
    pixels past an extent are not zeroed as the loader's padding is:
    constant regions tie max-pool windows, where JAX splits a gradient
    among the tied cells and PyTorch routes it to one
    (``tests/test_torch_train_step.py``), which would move the VGG convs'
    gradients of the two frameworks apart by up to 4.5e-3 relative L2
    here, whatever the world size."""
    rs = np.random.RandomState(seed)
    images = rs.normal(size=(b, *CANVAS, 3)).astype(np.float32)
    extents = np.tile(np.array([[1.0, 1.0], [0.7, 0.75]], np.float32), (-(-b // 2), 1))[:b]
    xy = rs.uniform(0.02, 0.2, size=(b, g, 2))
    wh = rs.uniform(0.15, 0.25, size=(b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32) * np.tile(extents, 2)[:, None]
    low = 1 if generation == "fpn" else 0  # raw ids for FPN, 0-based for legacy
    labels = rs.randint(low, low + NUM_CLASSES - 1, size=(b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[:, -1] = False
    boxes[:, -1] = 0.0
    return dict(zip(KEYS, (images, extents, boxes, labels, mask)))


def new_model(generation: str, remat: bool = False, num_classes: int = NUM_CLASSES):
    model, _ = pfr.build_model(generation, num_classes, remat=remat)
    pfr.init_weights(model, torch.Generator().manual_seed(0))
    return model


def new_state(
    generation: str, remat: bool = False, weights: str | None = None,
    num_classes: int = NUM_CLASSES,
):
    set_numerics("float32")
    model = new_model(generation, remat, num_classes)
    if weights:
        model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    lay = layout()
    apply_tensor_parallel(model, lay.model_group, lay.model_rank, lay.model_parallel)
    return pts.init_train_state(model, pts.make_optimizer(model))


def rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k][lo:hi])) for k in KEYS}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def full_grads(model) -> dict:
    """Every parameter's gradient in the single-device layout (the split
    ones gathered over the model group)."""
    from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import gather_state_dict

    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    lay = layout()
    if lay.model_parallel == 1:
        return grads
    # gather_state_dict gathers by the names of the split parameters
    return {
        k: v
        for k, v in gather_state_dict(model, lay.model_group, state=grads).items()
        if k in grads
    }


def errors(got: dict, want: dict) -> dict:
    """Per tensor of ``got``: ``(max|d|, max|ref|, ||d||, ||ref||)``
    against ``want``, which may hold more names (a second classifier
    alias)."""
    assert got.keys() <= want.keys(), sorted(set(got) - set(want))
    out = {}
    for k in got:
        v = want[k]
        d = (got[k] - v).double()
        out[k] = (float(d.abs().max()), float(v.abs().max()), float(d.norm()), float(v.double().norm()))
    return out


def train_steps(
    rank, generation, global_b, steps, accum=1, noise=None, record_counts=False, weights=None,
    batch_invariant=False, reference=None,
):
    """``steps`` steps of the DDP train step on this rank's rows of one
    seeded global batch. Returns the metrics of each step, the first
    step's gradients and the parameters after the last (single-device
    layout, from rank 0 only; with ``reference``, a file of
    ``{"grads", "params"}``, their :func:`errors` against it instead), a
    digest of every local parameter (to check that replicas agree bit for
    bit) and, with ``record_counts``,
    the loss counts this rank saw at each step. ``noise``: the global
    batch's ``TrainNoise`` in place of the generator (one step);
    ``weights``: a state dict file to start from. ``batch_invariant``:
    convolutions without oneDNN, whose CPU kernels for ResNet50's small
    late maps round an image differently in a batch of one and of two
    (P5 by 2e-6), which a ReLU or a tie can then amplify: the
    comparison of one image a rank with two in one process is then like
    with like."""
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = not batch_invariant and mkldnn
    try:
        out = _setup_and_train(
            rank, generation, global_b, steps, accum, noise, record_counts, weights
        )
    finally:
        torch.backends.mkldnn.enabled = mkldnn
    if reference and rank == 0:
        ref = torch.load(reference, weights_only=True, mmap=True)
        for key in ("grads", "params"):
            out[key] = errors(out[key], ref[key]) if key in ref else None
    return out


def _setup_and_train(rank, generation, global_b, steps, accum, noise, record_counts, weights):
    cfg = CONFIGS[generation]
    state = new_state(generation, weights=weights)
    lay = layout()
    b = global_b // lay.data_size
    batch = rows(make_batch(global_b, generation=generation), lay.data_rank * b, (lay.data_rank + 1) * b)
    seen = []
    if record_counts:
        reduce = pts.data_group_count_reduce

        def recording(counts):
            seen.append(counts.tolist())
            return reduce(counts)

        pts.data_group_count_reduce = recording
    try:
        return _train_steps(rank, cfg, state, lay, batch, steps, accum, noise, seen)
    finally:
        if record_counts:
            pts.data_group_count_reduce = reduce


def _train_steps(rank, cfg, state, lay, batch, steps, accum, noise, seen):
    from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import gather_state_dict

    schedule = pts.make_lr_schedule("constant", LR, 1, 1)
    step_fn = pts.make_train_step(cfg, schedule, grad_accum=accum)
    gen = torch.Generator().manual_seed(11)
    metrics, grads = [], None
    for i in range(steps):
        m = step_fn(state, batch, noise if noise is not None else gen)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = full_grads(state.model)
    params = gather_state_dict(state.model, lay.model_group)
    out = {
        "metrics": metrics,
        "digests": {n: digest(p) for n, p in state.model.named_parameters()},
        "counts": seen,
    }
    if rank == 0:
        out["grads"], out["params"] = grads, params
    return out


def jobs(rank, specs):
    """Several jobs in one rank: ``[(function name, kwargs), ...]``."""
    return [globals()[name](rank, **kw) for name, kw in specs]


def tp_layout(rank):
    """This rank's shard shapes, and whether the gathered single-device
    state dict loads ``strict=True`` into a one-process model."""
    state = new_state("legacy")
    lay = layout()
    from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import gather_state_dict

    full = gather_state_dict(state.model, lay.model_group)
    new_model("legacy").load_state_dict(full, strict=True)
    return {
        "layout": (lay.data_rank, lay.data_size, lay.model_rank, lay.model_parallel),
        "shapes": {n: tuple(p.shape) for n, p in state.model.named_parameters()
                   if n.startswith("classifier.")},
        "loads_strict": True,
    }


def tp_checkpoint(rank, directory, num_classes=21):
    """One legacy step at this layout (VOC's 21 classes), then a
    checkpoint of each backend (the directory one asynchronous), each
    loaded back into a fresh state at this layout; digests of the
    single-device state it should hold."""
    from faster_rcnn_pytorch_tpu_torch.parallel import tensor_parallel as tp
    from faster_rcnn_pytorch_tpu_torch.utils import checkpoint as ck

    state = new_state("legacy", num_classes=num_classes)
    lay = layout()
    b = 2 // lay.data_size
    batch = rows(make_batch(2), lay.data_rank * b, (lay.data_rank + 1) * b)
    cfg = dataclasses.replace(LEGACY, num_classes=num_classes)
    step_fn = pts.make_train_step(cfg, pts.make_lr_schedule("constant", LR, 1, 1))
    step_fn(state, batch, torch.Generator().manual_seed(11))
    for backend, async_save in (("flax", False), ("orbax", True)):
        ck.save_checkpoint(
            f"{directory}/run.{backend}.pt", state, {"epoch": 3}, backend, async_save
        )
    ck.wait_for_checkpoints()
    resumes = {}
    for backend in ("flax", "orbax"):  # back into this layout: this rank's shards
        fresh = new_state("legacy", num_classes=num_classes)
        ck.load_checkpoint(f"{directory}/run.{backend}.pt", fresh)
        resumes[backend] = fresh.step == state.step and all(
            torch.equal(p, q) for p, q in zip(fresh.model.parameters(), state.model.parameters())
        )
    model = tp.gather_state_dict(state.model, lay.model_group)
    opt = tp.gather_optimizer_state(state.model, state.optimizer, lay.model_group)
    return {
        "model": {k: digest(v) for k, v in model.items()},
        "momentum": {i: digest(s["momentum_buffer"]) for i, s in opt["state"].items()},
        "resumes": resumes,
    }


class SyntheticLoader:
    """Loader-like eval batches (``batch_size`` images each) of seeded
    images on the canvas, with 1-3 gt boxes an image in ``records_by_id``."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        rs = np.random.RandomState(seed)
        self.batch_size = batch_size
        self.records_by_id, self.items = {}, []
        ch, cw = CANVAS
        for i in range(n):
            rh, rw = (ch, cw) if i % 2 == 0 else (int(ch * 0.75), int(cw * 0.8))
            k = rs.randint(1, 4)
            xy = rs.uniform(0, 0.5, size=(k, 2)) * (rw, rh)
            wh = rs.uniform(0.2, 0.4, size=(k, 2)) * (rw, rh)
            image = np.zeros((ch, cw, 3), np.float32)
            image[:rh, :rw] = rs.normal(size=(rh, rw, 3))
            self.records_by_id[i] = type("Record", (), dict(
                boxes=np.concatenate([xy, np.minimum(xy + wh, (rw, rh))], 1).astype(np.float32),
                labels=rs.randint(0, NUM_CLASSES - 1, size=k).astype(np.int32),
                difficult=np.zeros(k, bool),
            ))
            self.items.append((image, (rw / cw, rh / ch), i, (rh, rw)))

    def epoch(self, epoch: int = 0):
        for s in range(0, len(self.items), self.batch_size):
            part = self.items[s : s + self.batch_size]
            part = part + self.items[: self.batch_size - len(part)]  # wrap-pad
            image, extent, ids, hw = zip(*part)
            yield {
                "image": np.stack(image),
                "extent": np.array(extent, np.float32),
                "image_id": np.array(ids, np.int64),
                "orig_hw": np.array(hw, np.int32),
                "resized_hw": np.array(hw, np.int32),
            }


def write_coco_index(loader: SyntheticLoader, path: str) -> str:
    """A COCO annotation file of the loader's images and gt boxes
    (categories 1..5, the FPN head's raw ids)."""
    import json

    images, anns = [], []
    for i, rec in loader.records_by_id.items():
        h, w = loader.items[i][3]
        images.append({"id": i, "height": h, "width": w, "file_name": f"{i}.jpg"})
        for j, (box, lab) in enumerate(zip(rec.boxes, rec.labels)):
            x0, y0, x1, y1 = (float(v) for v in box)
            anns.append({"id": 100 * i + j, "image_id": i, "category_id": int(lab) + 1,
                         "bbox": [x0, y0, x1 - x0, y1 - y0], "area": (x1 - x0) * (y1 - y0),
                         "iscrowd": 0})
    cats = [{"id": c, "name": f"c{c}"} for c in range(1, NUM_CLASSES)]
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path


def eval_job(rank, data_type, n_images, batch_size, coco_path=None):
    """``evaluate`` of the seeded FPN (COCO) or legacy (VOC) model over
    the synthetic loader at this layout, or the error it raises."""
    from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex
    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate

    set_numerics("float32")
    generation = "fpn" if data_type == "coco" else "legacy"
    model = new_model(generation).eval()
    cfg = dataclasses.replace(CONFIGS[generation], label_offset=0 if data_type == "coco" else 1)
    loader = SyntheticLoader(n_images, batch_size)
    index = CocoIndex(coco_path) if coco_path else None
    try:
        result = evaluate(
            model, cfg, loader, data_type=data_type, coco_index=index,
            label_map=(lambda l: l + 1) if data_type == "coco" else None,
            score_threshold=0.0, verbose=False,
        )
    except ValueError as err:
        return str(err)
    return {"map": result["map"], "stats": result["stats"],
            "detections": result["detections"], "n_images": result["n_images"]}


def coco_sync_job(rank, coco_path):
    """Each rank's own predictions, merged by
    ``CocoEvaluator.synchronize_between_processes``."""
    from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex
    from faster_rcnn_pytorch_tpu_torch.evaluation.coco_eval import CocoEvaluator

    evaluator = CocoEvaluator(CocoIndex(coco_path))
    evaluator.update({rank: {"boxes": np.ones((1, 4)) * rank, "scores": [0.5], "labels": [1]}})
    evaluator.synchronize_between_processes()
    return sorted(evaluator.predictions)

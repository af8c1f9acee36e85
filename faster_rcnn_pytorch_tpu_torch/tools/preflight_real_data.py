"""Real-data readiness drill of the port (counterpart of the JAX package's
``tools/preflight_real_data.py``): one command between "VOC/COCO is
mounted" and the published numbers.

Given a data root and, optionally, a released reference ``.pth.tar``, it

  1. checks the on-disk layout (the trees ``data/voc.py`` and
     ``data/coco.py`` read, as the reference's downloaders leave them);
  2. with a ``.pth``/``.pth.tar`` checkpoint, imports it into a legacy
     detector of 21 (VOC) or 81 (COCO) classes through
     ``utils/checkpoint.py::load_reference_weights`` and reports the
     census: the file's state-dict keys and the model's parameter count;
  3. runs the eval of ``test.run`` in this process, bounded to the first
     ``FRT_PREFLIGHT_LIMIT`` (default 20) test images
     (``engine/evaluate.py::evaluate`` with ``max_images``), and prints
     the mAP and the images taken (``--dump_detections`` pickles the
     detections, as ``test`` does);
  4. prints the commands of the full published recipes.

It runs on CUDA card 0, or on the CPU under ``FRT_TORCH_DEVICE=cpu``;
without a card and without that choice it raises.

    python -m faster_rcnn_pytorch_tpu_torch.tools.preflight_real_data \\
        --data_type voc --data_root /data/voc [--checkpoint frcnn.best.pth.tar] \\
        [--resize 800] [--model_generation legacy] [--dtype bfloat16]
"""

from __future__ import annotations

import json
import os
import sys

LIMIT_ENV = "FRT_PREFLIGHT_LIMIT"


def check_voc_layout(root: str) -> dict:
    """Counts and spot checks of a VOC root; ``SystemExit`` with a layout
    diagnosis when the tree is unusable."""
    from PIL import Image

    from faster_rcnn_pytorch_tpu_torch.data.voc import discover_voc_dirs, load_voc_records

    report: dict = {"root": root}
    if not os.path.isdir(root):
        raise SystemExit(f"[preflight] VOC root {root!r} is not a directory")
    for split in ("trainval", "test"):
        dirs = discover_voc_dirs(root, split)
        recs = load_voc_records(root, split)
        report[split] = {"dirs": dirs, "images": len(recs)}
        if not dirs:
            raise SystemExit(
                f"[preflight] no directory under {root} contains {split!r} "
                "in its name — expected e.g. "
                f"{root}/VOCtrainval_2007/VOCdevkit/VOC2007/{{JPEGImages,Annotations}} "
                "(data/voc.py:82-89 discovery contract)"
            )
        if not recs:
            raise SystemExit(
                f"[preflight] {dirs} matched split {split!r} but no "
                "(Annotations/*.xml, JPEGImages/*.jpg) pairs were found"
            )
        # Spot check: the first record's image opens, at its XML size, and
        # its boxes lie inside it.
        r = recs[0]
        with Image.open(r.image_path) as im:
            w, h = im.size
        if (w, h) != (r.width, r.height):
            raise SystemExit(
                f"[preflight] {r.image_path}: XML size {(r.width, r.height)} != actual {(w, h)}"
            )
        if len(r.boxes) and not (r.boxes[:, 2].max() <= r.width and r.boxes[:, 3].max() <= r.height):
            raise SystemExit(f"[preflight] {r.image_path}: boxes exceed image bounds")
    return report


def check_coco_layout(root: str) -> dict:
    """Counts and spot checks of a COCO root: ``train2017/``, ``val2017/``
    and ``annotations/instances_{train,val}2017.json``."""
    from PIL import Image

    from faster_rcnn_pytorch_tpu_torch.data.coco import load_coco_records

    report: dict = {"root": root}
    if not os.path.isdir(root):
        raise SystemExit(f"[preflight] COCO root {root!r} is not a directory")
    for split in ("train2017", "val2017"):
        ann = os.path.join(root, "annotations", f"instances_{split}.json")
        img_dir = os.path.join(root, split)
        if not os.path.exists(ann):
            raise SystemExit(
                f"[preflight] missing {ann} — expected "
                f"{root}/annotations/instances_{{train,val}}2017.json"
            )
        if not os.path.isdir(img_dir):
            raise SystemExit(f"[preflight] missing image dir {img_dir}")
        recs, index = load_coco_records(img_dir, ann)
        report[split] = {"images": len(recs), "categories": len(index.cats)}
        if not recs:
            raise SystemExit(f"[preflight] {ann} yielded zero usable images")
        r = recs[0]
        if not os.path.exists(r.image_path):
            raise SystemExit(
                f"[preflight] annotation names {os.path.basename(r.image_path)} "
                f"but it is absent from {img_dir} — partial image download?"
            )
        with Image.open(r.image_path) as im:
            w, h = im.size
        if (w, h) != (r.width, r.height):
            raise SystemExit(f"[preflight] {r.image_path}: index size mismatch")
    return report


def check_checkpoint(path: str, generation: str, num_classes: int) -> dict:
    """Import a released reference checkpoint into a legacy detector of
    ``num_classes`` classes and report its census: ``torch_keys``, the
    file's state-dict keys, and ``params``, the model's parameter count."""
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import load_reference_weights
    from faster_rcnn_pytorch_tpu_torch.utils.pretrained import _looks_like_checkpoint

    if not os.path.exists(path):
        raise SystemExit(f"[preflight] checkpoint {path!r} does not exist")
    reason = _looks_like_checkpoint(path)
    if reason is not None:
        raise SystemExit(f"[preflight] {path!r} does not look like a torch checkpoint: {reason}")
    # Refused before the file is read: the census takes one read, not two.
    if generation != "legacy":
        raise SystemExit(
            "[preflight] only the legacy generation has released "
            "checkpoints (reference README.md:104-111)"
        )
    model, _ = build_model("legacy", num_classes)
    sd = load_reference_weights(model, path, "legacy")
    return {"path": path, "torch_keys": len(sd), "params": sum(p.numel() for p in model.parameters())}


def run_mini_eval(opts, limit: int) -> dict:
    """The eval of ``test.run`` in this process, over the first ``limit``
    test images (the batch that reaches ``limit`` is taken whole). Returns
    ``{"map", "images", "detections", "seconds"}``: ``images`` is the
    count ``evaluate`` took, ``detections`` its per-image detections."""
    from faster_rcnn_pytorch_tpu_torch.data.loader import build_dataloader
    from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate, label_map_for
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, label_offset_for
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import resolve_and_load_params
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        prepare_for_inference,
        select_device,
        set_numerics,
    )

    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    _, test_loader = build_dataloader(opts, train_rows=False)
    model, cfg = build_model(
        opts.model_generation,
        opts.num_classes,
        label_offset=label_offset_for(opts.model_generation, opts.data_type),
    )
    print(f"[preflight] {resolve_and_load_params(opts, model)}", flush=True)
    model = prepare_for_inference(model, select_device(), dtype)

    coco_index = None
    if opts.data_type == "coco":
        from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex

        coco_index = CocoIndex(os.path.join(opts.data_root, "annotations", "instances_val2017.json"))
    result = evaluate(
        model,
        cfg,
        test_loader,
        data_type=opts.data_type,
        coco_index=coco_index,
        label_map=label_map_for(opts, coco_index),
        score_threshold=opts.thres,
        max_images=limit,
        dump_path=opts.dump_detections or None,
        dtype=dtype,
    )
    return {
        "map": float(result["map"]),
        "images": result["n_images"],
        "detections": result["detections"],
        "seconds": result["seconds"],
    }


def full_recipe_commands(opts) -> list[str]:
    """The commands that reproduce the published table once the drill
    passes (reference README.md:104-137), through the port's CLIs."""
    if opts.data_type == "voc":
        return [
            "# VOC07 train -> AP50 71.00 (75.81 with 07+12 in the root):",
            "python -m faster_rcnn_pytorch_tpu_torch.main --config configs/voc_train.txt "
            f"--data_root {opts.data_root}"
            + (" --pretrained_backbone auto" if not opts.checkpoint else ""),
            "# eval the released checkpoint directly:",
            "python -m faster_rcnn_pytorch_tpu_torch.test --config configs/voc_train.txt "
            f"--data_root {opts.data_root} --checkpoint <frcnn.best.pth.tar>",
        ]
    return [
        "# COCO legacy recipe -> mAP 20.7:",
        "python -m faster_rcnn_pytorch_tpu_torch.main --config configs/coco_train.txt "
        f"--data_root {opts.data_root} --pretrained_backbone auto",
        "# exp1 FPN recipe -> mAP 24.1 (4-way data parallel):",
        "python -m faster_rcnn_pytorch_tpu_torch.main --config configs/coco_fpn_train.txt "
        f"--data_root {opts.data_root} --pretrained_backbone auto",
        "# eval a checkpoint:",
        "python -m faster_rcnn_pytorch_tpu_torch.test --config configs/coco_train.txt "
        f"--data_root {opts.data_root} --checkpoint <ckpt>",
    ]


def main(argv=None) -> int:
    from faster_rcnn_pytorch_tpu_torch.config import load_options

    opts = load_options(argv)
    limit = int(os.environ.get(LIMIT_ENV, "20"))

    print(f"[preflight] data layout check: {opts.data_type} at {opts.data_root}", flush=True)
    layout = check_voc_layout(opts.data_root) if opts.data_type == "voc" else check_coco_layout(opts.data_root)
    print(f"[preflight] layout ok: {json.dumps(layout, default=str)}", flush=True)

    if opts.checkpoint.endswith((".pth", ".pth.tar")):
        # legacy class counts by data type (data/loader.py::build_dataloader)
        census = check_checkpoint(opts.checkpoint, opts.model_generation, 21 if opts.data_type == "voc" else 81)
        print(f"[preflight] checkpoint ok: {json.dumps(census)}", flush=True)

    mini = run_mini_eval(opts, limit)
    print(f"[preflight] mini eval ok: {json.dumps({k: mini[k] for k in ('map', 'images')})}", flush=True)

    print("[preflight] PASS — full published-recipe commands:")
    for line in full_recipe_commands(opts):
        print("  " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

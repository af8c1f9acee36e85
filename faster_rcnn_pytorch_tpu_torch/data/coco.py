"""COCO dataset + a self-contained COCO annotation index.

The reference indexes COCO through pycocotools (datasets/coco_dataset.py,
new_datasets/coco_utils.py); pycocotools is not available in this image,
so :class:`CocoIndex` implements the small subset the framework needs
(image/annotation lookup, category handling) from the raw JSON — it also
backs the evaluator in :mod:`..evaluation.coco_eval`.

Reference parity notes:

* the legacy dataset iterates only images with >= 1 annotation
  (``imgToAnns.keys()``, datasets/coco_dataset.py:121),
* legacy label space: COCO category ids 1..90 remapped to contiguous
  0..79 (datasets/coco_dataset.py:124-128); the new-generation dataset
  keeps raw ids (new_datasets/coco_utils.py) — select via ``contiguous``,
* boxes come as xywh -> converted to xyxy; boxes with w or h < 1px are
  dropped (datasets/coco_dataset.py:220-240),
* crowd annotations are dropped (new_datasets/coco_utils.py:56).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from faster_rcnn_pytorch_tpu_torch.data.voc import Record

COCO_80_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


class CocoIndex:
    """Minimal COCO annotation index (pycocotools-free).

    Attributes mirror what the framework touches: ``imgs`` (id -> image
    dict), ``img_to_anns`` (id -> [ann dict]), ``cats`` (id -> cat dict),
    ``cat_ids`` sorted.
    """

    def __init__(self, annotation_file: str | dict):
        if isinstance(annotation_file, str):
            with open(annotation_file) as f:
                data = json.load(f)
        else:
            data = annotation_file
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.cat_ids = sorted(self.cats)
        self.anns = {}
        self.img_to_anns: dict[int, list] = defaultdict(list)
        for ann in data.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        # Contiguous remap 1..90 -> 0..79 (datasets/coco_dataset.py:124-128).
        self.cat_to_contiguous = {c: i for i, c in enumerate(self.cat_ids)}
        self.contiguous_to_cat = {i: c for c, i in self.cat_to_contiguous.items()}

    def image_ids_with_anns(self) -> list[int]:
        return sorted(self.img_to_anns.keys())

    def all_image_ids(self) -> list[int]:
        return sorted(self.imgs.keys())


def load_coco_records(
    image_root: str,
    annotation_file: str,
    contiguous: bool = True,
    drop_crowd: bool = True,
    include_empty: bool = False,
) -> tuple[list[Record], CocoIndex]:
    """Build loader records from a COCO annotation file.

    Args:
      contiguous: remap category ids to 0..79 (legacy generation); False
        keeps raw 1..90 ids minus 1 is NOT applied — the FPN generation
        consumes raw ids directly with ``label_offset=0``.
      include_empty: also iterate images without annotations (the legacy
        reference skips them).
    """
    index = CocoIndex(annotation_file)
    ids = index.all_image_ids() if include_empty else index.image_ids_with_anns()
    records = []
    for img_id in ids:
        info = index.imgs[img_id]
        boxes, labels = [], []
        for ann in index.img_to_anns.get(img_id, []):
            if drop_crowd and ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:  # degenerate (datasets/coco_dataset.py:230)
                continue
            boxes.append([x, y, x + w, y + h])
            cat = ann["category_id"]
            labels.append(index.cat_to_contiguous[cat] if contiguous else cat)
        records.append(
            Record(
                image_id=img_id,
                image_path=os.path.join(image_root, info["file_name"]),
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                difficult=np.zeros(len(labels), bool),
                width=info["width"],
                height=info["height"],
            )
        )
    if not include_empty:
        records = [r for r in records if len(r.boxes)]
    return records, index


# Official COCO archives (the reference downloads the same set,
# datasets/coco_dataset.py:25-77).
COCO_URLS = (
    "http://images.cocodataset.org/zips/train2017.zip",
    "http://images.cocodataset.org/zips/val2017.zip",
    "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
)


def download_coco(root: str) -> None:
    """Idempotent COCO download + extract; raises with instructions when
    the environment has no network egress."""
    ann = os.path.join(root, "annotations")
    if os.path.isdir(ann):
        return
    import urllib.request
    import zipfile

    os.makedirs(root, exist_ok=True)
    errors = []
    for url in COCO_URLS:
        marker = os.path.join(root, os.path.basename(url).replace(".zip", ""))
        if os.path.isdir(marker):
            continue
        zip_path = os.path.join(root, os.path.basename(url))
        try:
            if not os.path.exists(zip_path):
                print(f"downloading {url} ...")
                urllib.request.urlretrieve(url, zip_path)
            with zipfile.ZipFile(zip_path) as zf:
                zf.extractall(root)
        except Exception as e:
            errors.append(f"{url}: {e}")
    if errors and not os.path.isdir(ann):
        raise FileNotFoundError(
            f"No COCO data under {root!r} and download failed "
            f"({'; '.join(errors[:1])}). Place train2017/ val2017/ "
            "annotations/ under the data root."
        )

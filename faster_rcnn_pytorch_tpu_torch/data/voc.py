"""PASCAL VOC dataset (reference: datasets/voc_dataset.py).

Parses the VOC directory layout (JPEGImages/ + Annotations/*.xml) into
plain records; image decoding and augmentation happen in the loader.
Reference parity notes:

* 20-class list in the reference order (utils/label_info.py:4-9),
* box coords are parsed with the VOC 1-based convention -> minus 1
  (datasets/voc_dataset.py:218-253),
* ``difficult`` objects are kept with a flag (used by VOC evaluation to
  exclude them from the AP denominator, evaluation/voc_eval.py),
* train split may merge multiple years (2007+2012 trainval,
  datasets/voc_dataset.py:112-119).

The reference auto-downloads tars from mirrors
(datasets/voc_dataset.py:18-62); this build has no network egress, so
:func:`download_voc` validates an existing tree and raises with
instructions instead of fetching.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import xml.etree.ElementTree as ET

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
VOC_CLASS_TO_ID = {c: i for i, c in enumerate(VOC_CLASSES)}


@dataclasses.dataclass
class Record:
    image_id: int
    image_path: str
    boxes: np.ndarray  # [n, 4] float32 pixel xyxy
    labels: np.ndarray  # [n] int32
    difficult: np.ndarray  # [n] bool
    width: int
    height: int


def parse_voc_xml(path: str, keep_difficult: bool = True) -> dict:
    """One Annotations/*.xml -> boxes/labels/difficult + image size."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    boxes, labels, difficult = [], [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.lower().strip()
        if name not in VOC_CLASS_TO_ID:
            continue
        diff = bool(int(obj.find("difficult").text)) if obj.find("difficult") is not None else False
        if diff and not keep_difficult:
            continue
        bb = obj.find("bndbox")
        # VOC pixel indices are 1-based (datasets/voc_dataset.py:242-245).
        x1 = float(bb.find("xmin").text) - 1
        y1 = float(bb.find("ymin").text) - 1
        x2 = float(bb.find("xmax").text) - 1
        y2 = float(bb.find("ymax").text) - 1
        boxes.append([x1, y1, x2, y2])
        labels.append(VOC_CLASS_TO_ID[name])
        difficult.append(diff)
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int32),
        "difficult": np.asarray(difficult, bool),
        "width": width,
        "height": height,
    }


def discover_voc_dirs(root: str, split: str) -> list[str]:
    """Find VOC year dirs containing this split, like the reference's
    substring scan (datasets/voc_dataset.py:112-114)."""
    out = []
    for cand in sorted(glob.glob(os.path.join(root, "*"))):
        if os.path.isdir(cand) and split.lower() in os.path.basename(cand).lower():
            out.append(cand)
    return out


def load_voc_records(
    root: str, split: str = "trainval", keep_difficult: bool = True
) -> list[Record]:
    """Collect records across all matching year dirs.

    Expects ``root/<dir-with-split-name>/**/JPEGImages/*.jpg`` alongside
    ``Annotations/`` (datasets/voc_dataset.py:116-119).
    """
    records: list[Record] = []
    image_id = 0
    for d in discover_voc_dirs(root, split):
        ann_dirs = sorted(
            glob.glob(os.path.join(d, "**", "Annotations"), recursive=True)
        )
        for ann_dir in ann_dirs:
            img_dir = os.path.join(os.path.dirname(ann_dir), "JPEGImages")
            for xml_path in sorted(glob.glob(os.path.join(ann_dir, "*.xml"))):
                stem = os.path.splitext(os.path.basename(xml_path))[0]
                img_path = os.path.join(img_dir, stem + ".jpg")
                if not os.path.exists(img_path):
                    continue
                parsed = parse_voc_xml(xml_path, keep_difficult)
                records.append(
                    Record(
                        image_id=image_id,
                        image_path=img_path,
                        boxes=parsed["boxes"],
                        labels=parsed["labels"],
                        difficult=parsed["difficult"],
                        width=parsed["width"],
                        height=parsed["height"],
                    )
                )
                image_id += 1
    return records


# Mirrors used by the reference (datasets/voc_dataset.py:18-26).
VOC_URLS = {
    "VOCtrainval_2007": "https://pjreddie.com/media/files/VOCtrainval_06-Nov-2007.tar",
    "VOCtest_2007": "https://pjreddie.com/media/files/VOCtest_06-Nov-2007.tar",
    "VOCtrainval_2012": "https://pjreddie.com/media/files/VOCtrainval_11-May-2012.tar",
}


def download_voc(root: str) -> None:
    """Idempotent VOC download + extract (datasets/voc_dataset.py:18-62).

    Skips anything already present; raises with instructions when the
    environment has no network egress.
    """
    if discover_voc_dirs(root, "trainval") and discover_voc_dirs(root, "test"):
        return
    import os
    import tarfile
    import urllib.request

    os.makedirs(root, exist_ok=True)
    errors = []
    for name, url in VOC_URLS.items():
        dest_dir = os.path.join(root, name)
        if os.path.isdir(dest_dir):
            continue
        tar_path = os.path.join(root, os.path.basename(url))
        try:
            if not os.path.exists(tar_path):
                print(f"downloading {url} ...")
                urllib.request.urlretrieve(url, tar_path)
            with tarfile.open(tar_path) as tf:
                tf.extractall(dest_dir)
        except Exception as e:  # no egress / mirror down
            errors.append(f"{url}: {e}")
    if errors and not discover_voc_dirs(root, "trainval"):
        raise FileNotFoundError(
            f"No VOC data under {root!r} and download failed "
            f"({'; '.join(errors[:2])}). Place extracted VOCdevkit trees "
            "(e.g. VOCtrainval_2007/, VOCtest_2007/) under the data root."
        )

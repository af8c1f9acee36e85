"""The port's COCO bbox evaluator against the JAX package's.

Seeded ground truth (several categories, crowd boxes, all three area
ranges, an image without annotations) and seeded predictions (jittered
copies of the gts plus random boxes, random scores and labels, more than
100 per image for some images, so every maxDets budget cuts) go through
both evaluators, each with its own package's ``CocoIndex``: all twelve
summary stats and the per-class APs agree within 1e-12.
"""

import numpy as np
import pytest

from faster_rcnn_pytorch_tpu.data.coco import CocoIndex as JaxCocoIndex
from faster_rcnn_pytorch_tpu.evaluation.coco_eval import CocoEvaluator as JaxCocoEvaluator
from faster_rcnn_pytorch_tpu_torch.data.coco import CocoIndex
from faster_rcnn_pytorch_tpu_torch.evaluation.coco_eval import CocoEvaluator

CATS = (1, 3, 18, 44, 90)


def _dataset(rs, n_images=12):
    images, anns = [], []
    for i in range(n_images):
        images.append({"id": i, "file_name": f"{i:012d}.jpg", "width": 640, "height": 480})
        if i == n_images - 1:
            continue  # an image without annotations
        for _ in range(rs.randint(1, 8)):
            side = float(np.exp(rs.uniform(np.log(8), np.log(300))))  # small .. large
            w, h = side * rs.uniform(0.5, 1.5), side * rs.uniform(0.5, 1.5)
            x, y = rs.uniform(0, 640 - w), rs.uniform(0, 480 - h)
            anns.append(
                {
                    "id": len(anns) + 1,
                    "image_id": i,
                    "category_id": int(rs.choice(CATS)),
                    "bbox": [x, y, w, h],
                    "area": w * h,
                    "iscrowd": int(rs.rand() < 0.1),
                }
            )
    return {
        "images": images,
        "annotations": anns,
        "categories": [{"id": c, "name": str(c)} for c in CATS],
    }


def _predictions(rs, data):
    preds = {}
    for img in data["images"]:
        gts = [a for a in data["annotations"] if a["image_id"] == img["id"]]
        boxes, labels = [], []
        for a in gts:
            x, y, w, h = a["bbox"]
            for _ in range(rs.randint(0, 4)):
                j = rs.normal(scale=0.1, size=4) * [w, h, w, h]
                boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
                labels.append(a["category_id"] if rs.rand() < 0.8 else int(rs.choice(CATS)))
        n_random = rs.randint(0, 150)
        xy = rs.uniform(0, 600, size=(n_random, 2))
        wh = rs.uniform(4, 200, size=(n_random, 2))
        boxes.extend(np.concatenate([xy, xy + wh], 1).tolist())
        labels.extend(rs.choice(CATS, size=n_random).tolist())
        preds[img["id"]] = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "scores": rs.uniform(0.05, 1.0, size=len(labels)).astype(np.float32),
            "labels": np.asarray(labels, np.int64),
        }
    return preds


@pytest.mark.parametrize("seed", [0, 1])
def test_port_coco_stats_equal_jax(seed):
    rs = np.random.RandomState(seed)
    data = _dataset(rs)
    preds = _predictions(rs, data)
    assert max(len(p["scores"]) for p in preds.values()) > 100

    want = JaxCocoEvaluator(JaxCocoIndex(data))
    want.update(preds)
    want.accumulate()
    want_stats = want.summarize()

    got = CocoEvaluator(CocoIndex(data))
    got.update(preds)
    got.accumulate()
    got_stats = got.summarize()

    assert got_stats.shape == (12,) and (want_stats > 0).any()
    np.testing.assert_allclose(got_stats, want_stats, rtol=0, atol=1e-12)
    assert got.per_class_ap.keys() == want.per_class_ap.keys()
    for cat, ap in want.per_class_ap.items():
        assert abs(got.per_class_ap[cat] - ap) <= 1e-12, cat

"""The port's COCO RLE codec and result preparation against the JAX
package's (``evaluation/mask_rle.py``, ``CocoEvaluator.prepare``).

The cases of ``tests/test_mask_rle.py`` on the port's copy, then the two
packages side by side on seeded inputs (numpy ``RandomState``): masks of
random sizes and densities (empty, full, single-pixel and striped ones
among them) give identical run lengths, identical compressed strings
(the maskApi varint with its ``cnts[i-2]`` delta from the fourth count
on) and identical IoUs, and each decodes to its mask; ``prepare`` gives
identical records for ``bbox``, ``segm`` (probability masks, both
``[n, h, w]`` and ``[n, 1, h, w]``) and ``keypoints``, and the same
``ValueError`` for an unknown type. One difference is deliberate: the
JAX package's keypoint preparation raises on an image without
detections (``reshape(0, -1)``); the port's gives that image no record,
as the reference's ``flatten(start_dim=1)`` does. Exact equality throughout: both are
the same integer and float64 arithmetic.
"""

import numpy as np
import pytest

from faster_rcnn_pytorch_tpu.evaluation import mask_rle as jax_rle
from faster_rcnn_pytorch_tpu.evaluation.coco_eval import CocoEvaluator as JaxEvaluator
from faster_rcnn_pytorch_tpu_torch.evaluation import mask_rle
from faster_rcnn_pytorch_tpu_torch.evaluation.coco_eval import CocoEvaluator


def test_counts_col_major_and_leading_zero_run():
    mask = np.array([[1, 0], [0, 1]], bool)
    assert mask_rle.mask_to_counts(mask) == [0, 1, 2, 1]
    np.testing.assert_array_equal(mask_rle.counts_to_mask([0, 1, 2, 1], (2, 2)), mask)


def test_varint_singletons():
    assert mask_rle.counts_to_string([1]) == "1"
    assert mask_rle.string_to_counts("1") == [1]
    assert mask_rle.counts_to_string([0, 1]) == "01"
    assert mask_rle.string_to_counts("01") == [0, 1]


@pytest.mark.parametrize("counts", [[3, 5, 2, 9, 4, 1], [0, 40, 7, 3, 1000, 2], [5, 5, 5, 5]])
def test_varint_delta_quirk(counts):
    s = mask_rle.counts_to_string(counts)
    assert all(48 <= ord(c) < 48 + 64 for c in s)
    assert mask_rle.string_to_counts(s) == counts
    assert s == jax_rle.counts_to_string(counts)


def test_uncompressed_and_bytes_counts_accepted():
    mask = np.eye(5, dtype=bool)
    rle = {"size": [5, 5], "counts": mask_rle.mask_to_counts(mask)}
    np.testing.assert_array_equal(mask_rle.decode(rle), mask)
    packed = {"size": [5, 5], "counts": mask_rle.encode(mask)["counts"].encode()}
    np.testing.assert_array_equal(mask_rle.decode(packed), mask)


def test_mask_iou_crowd_semantics():
    a = np.zeros((4, 4), bool)
    a[:2] = True
    b = np.zeros((4, 4), bool)
    b[1:3] = True
    ra, rb = mask_rle.encode(a), mask_rle.encode(b)
    np.testing.assert_allclose(mask_rle.iou(ra, rb), 4 / 12)
    np.testing.assert_allclose(mask_rle.iou(ra, rb, iscrowd=True), 4 / 8)


def seeded_masks(seed: int, n: int = 40) -> list:
    rs = np.random.RandomState(seed)
    masks = [np.zeros((3, 7), bool), np.ones((6, 2), bool), np.eye(1, dtype=bool)]
    stripes = np.zeros((9, 33), bool)
    stripes[:, ::2] = True  # runs of one, then deltas that change sign
    masks.append(stripes)
    for _ in range(n):
        h, w = rs.randint(1, 60, size=2)
        masks.append(rs.rand(h, w) > rs.uniform(0.05, 0.95))
    return masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_fuzz_matches_jax(seed):
    masks = seeded_masks(seed)
    for m in masks:
        counts = mask_rle.mask_to_counts(m)
        assert counts == jax_rle.mask_to_counts(m)
        rle = mask_rle.encode(m)
        assert rle == jax_rle.encode(m)
        assert rle["size"] == list(m.shape)
        assert mask_rle.string_to_counts(rle["counts"]) == counts
        np.testing.assert_array_equal(mask_rle.decode(rle), m)
        np.testing.assert_array_equal(jax_rle.decode(rle), m)
    rs = np.random.RandomState(seed + 10)
    for _ in range(20):
        h, w = rs.randint(1, 30, size=2)
        a, b = rs.rand(2, h, w) > rs.uniform(0.2, 0.8)
        ra, rb = mask_rle.encode(a), mask_rle.encode(b)
        for crowd in (False, True):
            assert mask_rle.iou(ra, rb, crowd) == jax_rle.iou(ra, rb, crowd)


def seeded_predictions(seed: int, mask_dims: int) -> dict:
    """``{image_id: {"boxes", "scores", "labels", "masks", "keypoints"}}``:
    xyxy boxes, probability masks ``[n, h, w]`` or ``[n, 1, h, w]``, 17
    keypoints (x, y, visibility) a detection; an image with none."""
    rs = np.random.RandomState(seed)
    preds = {}
    for img_id, n in ((3, 5), (11, 1), (42, 0), (7, 8)):
        xy = rs.uniform(0, 300, size=(n, 2))
        wh = rs.uniform(1, 200, size=(n, 2))
        h, w = rs.randint(8, 40, size=2)
        masks = rs.uniform(0, 1, size=(n, h, w)).astype(np.float32)
        preds[img_id] = {
            "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
            "scores": rs.uniform(0.05, 1, size=n).astype(np.float32),
            "labels": rs.randint(1, 91, size=n),
            "masks": masks[:, None] if mask_dims == 4 else masks,
            "keypoints": np.concatenate(
                [rs.uniform(0, 300, size=(n, 17, 2)), rs.randint(0, 3, size=(n, 17, 1))], 2
            ).astype(np.float32),
        }
    return preds


@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints"])
@pytest.mark.parametrize("mask_dims", [3, 4])
def test_prepare_records_match_jax(iou_type, mask_dims):
    preds = seeded_predictions(5 + mask_dims, mask_dims)
    got = CocoEvaluator(None).prepare(preds, iou_type)
    if iou_type == "keypoints":  # the JAX copy cannot reshape image 42's empty [0, 17, 3]
        with pytest.raises(ValueError, match="reshape"):
            JaxEvaluator(None).prepare(preds, iou_type)
        del preds[42]
        assert CocoEvaluator(None).prepare(preds, iou_type) == got
    want = JaxEvaluator(None).prepare(preds, iou_type)
    assert got == want
    assert len(got) == 14
    for r in got:
        assert set(r) == {"image_id", "category_id", "score", {"bbox": "bbox", "segm": "segmentation",
                                                               "keypoints": "keypoints"}[iou_type]}
        assert type(r["image_id"]) is int and type(r["category_id"]) is int and type(r["score"]) is float
    if iou_type == "segm":
        masks = preds[3]["masks"].reshape(5, *preds[3]["masks"].shape[-2:])
        for r, m in zip(got, masks):
            np.testing.assert_array_equal(mask_rle.decode(r["segmentation"]), m > 0.5)
    if iou_type == "keypoints":
        assert len(got[0]["keypoints"]) == 51


def test_prepare_paths_emit_coco_records():
    preds = {
        3: {
            "boxes": np.array([[10.0, 20.0, 30.0, 60.0]]),
            "scores": np.array([0.9]),
            "labels": np.array([17]),
            "masks": np.ones((1, 1, 6, 6)) * 0.7,
            "keypoints": np.array([[[1.0, 2.0, 2.0], [3.0, 4.0, 1.0]]]),
        }
    }
    det = CocoEvaluator.prepare_for_coco_detection(preds)
    assert det == [{"image_id": 3, "category_id": 17, "bbox": [10.0, 20.0, 20.0, 40.0], "score": 0.9}]
    seg = CocoEvaluator.prepare_for_coco_segmentation(preds)
    assert seg[0]["segmentation"]["size"] == [6, 6]
    np.testing.assert_array_equal(mask_rle.decode(seg[0]["segmentation"]), np.ones((6, 6), bool))
    kp = CocoEvaluator.prepare_for_coco_keypoint(preds)
    assert kp[0]["keypoints"] == [1.0, 2.0, 2.0, 3.0, 4.0, 1.0]


def test_prepare_refuses_an_unknown_type():
    preds = seeded_predictions(0, 3)
    with pytest.raises(ValueError, match="unknown iou type 'boxes'") as got:
        CocoEvaluator(None).prepare(preds, "boxes")
    with pytest.raises(ValueError) as want:
        JaxEvaluator(None).prepare(preds, "boxes")
    assert str(got.value) == str(want.value)

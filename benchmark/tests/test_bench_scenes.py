"""The scene pools repeat per seed, and every seed gets the same amount of
work: the same extents and the same multiset of box counts."""

import numpy as np
import pytest

from benchmark.lib import manifest, scenes

TRAFFIC = {"batch": 4, "max_gt": 12, "labels": [1, 90],
           "box_counts": {"histogram": [[1, 6], [3, 3], [12, 3]]}}


@pytest.fixture
def three_batches(monkeypatch):
    monkeypatch.setattr(scenes, "POOL", 3)


@pytest.mark.usefixtures("three_batches")
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_pool_repeats_per_seed(seed):
    a = scenes.pool(TRAFFIC, (64, 96), seed, "cpu")
    b = scenes.pool(TRAFFIC, (64, 96), seed, "cpu")
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.usefixtures("three_batches")
def test_seeds_change_content_not_amount():
    a = scenes.pool(TRAFFIC, (64, 96), 1, "cpu")
    b = scenes.pool(TRAFFIC, (64, 96), 2, "cpu")
    count = lambda p: sorted(int(n) for x in p for n in x["gt_mask"].sum(1))  # noqa: E731
    assert count(a) == count(b) == sorted([1] * 6 + [3] * 3 + [12] * 3)
    assert not np.array_equal(a[0]["image"], b[0]["image"])
    np.testing.assert_array_equal(a[0]["extent"], b[0]["extent"])
    for x in a:
        ext = x["extent"]
        assert (x["gt_boxes"][..., 2] <= ext[:, None, 0] + 1e-6).all()
        assert (x["gt_labels"][x["gt_mask"]] >= 1).all() and (x["gt_labels"][x["gt_mask"]] <= 90).all()
        # pixels past the extent are zero, as the loader pads them
        h = int(round(ext[1, 1] * 64))
        assert not x["image"][1, h:].any()


@pytest.mark.parametrize("w", manifest.manifest()["workloads"], ids=lambda w: w["name"])
def test_cell_box_counts_fill_the_pool(w):
    t = manifest.cell(w["name"]).traffic
    if "box_counts" in t:
        counts = scenes.box_counts(t["box_counts"], scenes.POOL * t["batch"])
        assert counts.min() >= 1 and counts.max() <= t["max_gt"]

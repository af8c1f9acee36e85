"""On the card: each one-card cell's timed path against the plain
reference at a small canvas, traced, with every hand kernel it launches
found in the trace under the names ``roofline/kernels/`` gives."""

import time

import pytest

from benchmark.lib import manifest, result
from benchmark.tests import small

ONE_CARD = [w["name"] for w in manifest.manifest()["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
def test_cell_on_the_card(card, name):
    c = small.cell(name)
    kind = manifest.traffic_module(c.traffic["kind"])
    out = kind.run(c, 2**31 + 23, 1.0, True, card, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    metrics = result.per_layer(c, out["record"])
    key = "hand_kernels_roofline." + c.traffic["kind"]
    assert 0 < metrics[key]["value"] <= 100
    assert out["record"].busy_s() > 0

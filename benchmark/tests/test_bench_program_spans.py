"""The readers of the program's own spans and counters
(``lib/program_spans.py`` and the metrics that call it): medians of each
step's summed self time over the unprofiled steps, the counter over its
items, nothing where the program records nothing, and every such metric
read in a small traced run of each traffic kind."""

import pytest

from benchmark.lib import manifest, program_spans, result
from benchmark.lib.trace import Record
from benchmark.tests import small
from faster_rcnn_pytorch_tpu_torch.utils import logging as tracing

SPAN_METRICS = [m for m in manifest.manifest()["per_layer"] if m["source"] == "program_span"]
NEW = {m["name"] for m in SPAN_METRICS if m["name"].split(".")[0].endswith(("_host_ms", "_candidates"))}


def fake(spans=(), counters=None):
    out = {"spans": {}, "counters": counters or {}}
    for name, step, self_ms, profiled in spans:
        out["spans"].setdefault(name, []).append(
            tracing.Span(name, 0, 0, None, step, int(self_ms * 1e6), profiled)
        )
    return out


def test_host_ms_is_the_median_step_sum_of_unprofiled_steps(monkeypatch):
    snap = fake([
        ("train.forward", 0, 1.0, False), ("train.forward", 0, 2.0, False),  # two micro-batches
        ("train.forward", 1, 5.0, False),
        ("train.forward", 2, 4.0, False),
        ("train.forward", 3, 100.0, True),  # profiled: left out
    ])
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert program_spans.host_ms("train.forward") == pytest.approx(4.0)
    assert program_spans.host_ms("train.update") is None


def test_per_item_divides_the_counter_by_its_items(monkeypatch):
    snap = fake(counters={"class_nms.candidates": tracing.Counter(3000.0, 8)})
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert program_spans.per_item("class_nms.candidates") == pytest.approx(375.0)
    assert program_spans.per_item("other") is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(tracing, "snapshot")
    assert program_spans.snapshot() is None
    for m in SPAN_METRICS:
        if m["name"] in NEW:
            kind = m["name"].rsplit(".", 1)[1]
            assert manifest.metric_reader(m["name"])(Record(kind=kind)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_metric_reads_only_its_own_kind_and_present_spans(name, monkeypatch):
    kind = name.rsplit(".", 1)[1]
    other = "predict" if kind == "train" else "train"
    read = manifest.metric_reader(name)
    monkeypatch.setattr(program_spans, "snapshot", lambda: fake())
    assert read(Record(kind=kind)) is None
    spans = [(f"{kind}.{s}", 0, 2.5, False) for s in (
        "forward", "propose", "rpn_match", "rpn_labels", "roi_match", "roi_sample", "head_loss",
        "backward", "update", "class_nms")]
    snap = fake(spans, {"class_nms.candidates": tracing.Counter(10.0, 4)})
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert read(Record(kind=other)) is None
    assert read(Record(kind=kind)) == pytest.approx(2.5)


def test_twelve_entries_with_their_layers():
    assert len(NEW) == 12
    layers = {m["name"]: m["layer"] for m in SPAN_METRICS}
    assert layers["forward_host_ms.train"] == "Backbone + RPN head"
    assert layers["head_loss_host_ms.train"] == "RoI head"
    assert {layers[n] for n in NEW} <= {"Backbone + RPN head", "Proposals + NMS", "Train targets",
                                        "RoI head", "Train loop"}


@pytest.mark.parametrize("cell", ["legacy_voc_train_b8", "fpn_coco_predict_b8"])
def test_a_traced_run_reads_every_span_metric_of_its_cell(cell):
    c = small.cell(cell)
    tracing.reset()
    out = small.run(c, trace=True)
    metrics = result.per_layer(c, out["record"])
    want = {m["name"] for m in c.per_layer if m["name"] in NEW}
    assert want and want <= set(metrics)
    assert all(metrics[n]["value"] >= 0 for n in want)

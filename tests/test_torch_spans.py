"""The program's spans and counters (``utils/logging.py``) on the CPU.

A train step of either generation records every ``train.*`` span once
(a micro-batch's spans once a micro-batch), with its parent and the
step's one id; a predict call its seven stages in order under
``predict.call``, while a caller's ``on_stage`` still sees each stage.
Under ``torch.profiler`` the spans are ``frcnn.*`` ranges of the Chrome
trace, nested as the spans are; with no profiler no range is opened and
no counter moves. ``class_nms.candidates`` counts the (class, roi) pairs
over the threshold in each regime of ``multiclass_nms_batch``. Small
canvases; on the CPU every op takes its plain twin.
"""

import json
import threading

import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.ops.nms import multiclass_nms_batch
from faster_rcnn_pytorch_tpu_torch.parallel import train_step as pts
from faster_rcnn_pytorch_tpu_torch.utils import logging as tracing

CANVAS = {"legacy": (128, 192), "fpn": (128, 160), "cascade": (128, 160)}
NUM_CLASSES = 6
KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")
TARGET_SPANS = tuple(f"train.{s}" for s in pfr.TRAIN_TARGET_STAGES)
TRAIN_PARENTS = {
    "train.step": None,
    "train.forward": "train.step",
    "train.targets": "train.step",
    **{name: "train.targets" for name in TARGET_SPANS},
    "train.head_loss": "train.step",
    "train.backward": "train.step",
    "train.update": "train.step",
}
PREDICT_SPANS = tuple(f"predict.{s}" for s in pfr.PREDICT_STAGES)


def make_model(generation):
    model, cfg = pfr.build_model(generation, num_classes=NUM_CLASSES)
    pfr.init_weights(model, torch.Generator().manual_seed(0))
    return model, cfg


def make_batch(generation, b=2, g=4, seed=0):
    rs = np.random.RandomState(seed)
    h, w = CANVAS[generation]
    xy = rs.uniform(0.05, 0.35, size=(b, g, 2))
    wh = rs.uniform(0.3, 0.55, size=(b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 0.84)], -1).astype(np.float32)
    values = (
        rs.normal(size=(b, h, w, 3)).astype(np.float32),
        np.array([[1.0, 1.0], [0.9, 0.85]] * b, np.float32)[:b],
        boxes,
        rs.randint(0, NUM_CLASSES - 1, size=(b, g)).astype(np.int32),
        np.ones((b, g), bool),
    )
    return {k: torch.from_numpy(v) for k, v in zip(KEYS, values)}


def run_step(generation, grad_accum=1, b=2):
    model, cfg = make_model(generation)
    state = pts.init_train_state(model, pts.make_optimizer(model))
    step_fn = pts.make_train_step(cfg, pts.make_lr_schedule("constant", 1e-3, 1, 1), grad_accum)
    tracing.reset()
    step_fn(state, make_batch(generation, b=b), torch.Generator().manual_seed(1))
    return tracing.snapshot()


@pytest.fixture(scope="module", params=["legacy", "fpn"])
def train_spans(request):
    return run_step(request.param)["spans"]


@pytest.fixture(scope="module", params=["legacy", "fpn"])
def predict_run(request):
    model, cfg = make_model(request.param)
    batch = make_batch(request.param)
    seen = []
    tracing.reset()
    with torch.no_grad():
        dets = pfr.predict(
            model, cfg, batch["image"], batch["extent"], 0.05,
            on_stage=lambda name, result: seen.append((name, result)),
        )
    return tracing.snapshot()["spans"], seen, dets


def test_train_step_records_every_span_once(train_spans):
    assert set(train_spans) == set(TRAIN_PARENTS)
    steps = set()
    for name, parent in TRAIN_PARENTS.items():
        (s,) = train_spans[name]
        assert s.parent == parent, name
        assert s.end_ns >= s.start_ns and 0 <= s.self_ns <= s.end_ns - s.start_ns
        assert not s.profiled
        steps.add(s.step)
    assert len(steps) == 1


def test_targets_stages_in_order_within_targets(train_spans):
    (targets,) = train_spans["train.targets"]
    stages = [train_spans[name][0] for name in TARGET_SPANS]
    assert sum(s.self_ns for s in stages) <= targets.end_ns - targets.start_ns
    assert targets.self_ns == targets.end_ns - targets.start_ns - sum(
        s.end_ns - s.start_ns for s in stages
    )
    starts = [s.start_ns for s in stages]
    assert starts == sorted(starts) and targets.start_ns <= starts[0]
    assert stages[-1].end_ns <= targets.end_ns


def test_step_self_time_excludes_its_children(train_spans):
    (step,) = train_spans["train.step"]
    children = [train_spans[n][0] for n, p in TRAIN_PARENTS.items() if p == "train.step"]
    covered = sum(s.end_ns - s.start_ns for s in children)
    assert step.self_ns == step.end_ns - step.start_ns - covered >= 0


def test_micro_batches_repeat_their_spans_under_the_step_id():
    spans = run_step("legacy", grad_accum=2)["spans"]
    for name, parent in TRAIN_PARENTS.items():
        want = 1 if name in ("train.step", "train.update") else 2
        assert len(spans[name]) == want, name
    assert len({s.step for ss in spans.values() for s in ss}) == 1


def test_predict_records_its_stages_in_order(predict_run):
    spans, seen, dets = predict_run
    assert set(spans) == {"predict.call", *PREDICT_SPANS}
    (call,) = spans["predict.call"]
    assert call.parent is None
    stages = [spans[name][0] for name in PREDICT_SPANS]
    assert all(s.parent == "predict.call" and s.step == call.step for s in stages)
    starts = [s.start_ns for s in stages]
    assert starts == sorted(starts)
    assert call.start_ns <= starts[0] and stages[-1].end_ns <= call.end_ns
    assert call.self_ns == call.end_ns - call.start_ns - sum(s.end_ns - s.start_ns for s in stages)
    assert [name for name, _ in seen] == list(pfr.PREDICT_STAGES)
    assert seen[-1][1] is dets


def test_profiler_trace_nests_the_frcnn_ranges(tmp_path):
    model, cfg = make_model("legacy")
    batch = make_batch("legacy")
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pfr.predict(model, cfg, batch["image"], batch["extent"], 0.05)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {
        e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("cat") == "user_annotation" and e["name"].startswith("frcnn.")
    }
    assert set(ranges) == {"frcnn.predict.call", *(f"frcnn.{n}" for n in PREDICT_SPANS)}
    lo, hi = ranges["frcnn.predict.call"]
    previous_end = lo
    for name in PREDICT_SPANS:
        start, end = ranges[f"frcnn.{name}"]
        assert previous_end <= start and end <= hi, name
        previous_end = end
    spans = tracing.snapshot()["spans"]
    assert all(s.profiled for ss in spans.values() for s in ss)
    assert tracing.snapshot()["counters"]["class_nms.candidates"].n == 2


def test_no_profiler_opens_no_range_and_counts_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model, cfg = make_model("legacy")
    batch = make_batch("legacy")
    tracing.reset()
    pfr.predict(model, cfg, batch["image"], batch["extent"], 0.05)
    snap = tracing.snapshot()
    assert snap["counters"] == {}
    assert len(snap["spans"]["predict.call"]) == 1


def _class_probs(b, n, num_classes, fg_share, seed):
    """Probabilities with about ``fg_share`` of the foreground (class,
    roi) pairs over 0.05."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, n, num_classes, generator=g)
    over = torch.rand(b, n, num_classes, generator=g) < fg_share
    logits = torch.where(over, logits + 8.0, logits - 8.0)
    logits[..., 0] = 4.0
    return torch.softmax(logits, -1)


@pytest.mark.parametrize(
    "regime, n, num_classes, fg_share",
    [
        ("offset", 60, 6, 0.3),  # n_fg * n <= 16384: one offset-trick pass
        ("compact", 300, 91, 0.005),  # fewer than K candidates: the top-K pass
        ("per_class", 300, 91, 0.2),  # more than K: the per-class pass
    ],
)
def test_class_nms_candidates_count_the_pairs_over_the_threshold(regime, n, num_classes, fg_share):
    b, thr = 3, 0.05
    probs = _class_probs(b, n, num_classes, fg_share, seed=n + num_classes)
    g = torch.Generator().manual_seed(7)
    xy = torch.rand(b, n, num_classes, 2, generator=g) * 0.6
    boxes = torch.cat([xy, xy + 0.1 + 0.3 * torch.rand(b, n, num_classes, 2, generator=g)], -1)
    over = (probs[..., 1:] > thr).sum(dim=(1, 2))
    if regime == "offset":
        assert (num_classes - 1) * n <= 16384
    else:
        k_cand = max(512, 200)
        assert ((over <= k_cand) if regime == "compact" else (over > k_cand)).all()
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        multiclass_nms_batch(boxes, probs, thr, 0.3, num_classes)
        multiclass_nms_batch(boxes[:1], probs[:1], thr, 0.3, num_classes)
    counter = tracing.snapshot()["counters"]["class_nms.candidates"]
    assert counter.n == b + 1
    assert counter.value == int(over.sum()) + int(over[0])


def test_reset_empties_the_recorder_and_memory_stays_bounded():
    recorder = tracing.SpanRecorder()
    steps = tracing.SPANS_KEPT + 100
    for _ in range(steps):
        with recorder.span("outer"):
            with recorder.span("inner"):
                pass
    spans = recorder.snapshot()["spans"]
    assert {name: len(s) for name, s in spans.items()} == {
        "outer": tracing.SPANS_KEPT, "inner": tracing.SPANS_KEPT
    }
    outer = [s.step for s in spans["outer"]]
    assert outer == [s.step for s in spans["inner"]] == list(range(outer[0], outer[0] + len(outer)))
    recorder.reset()
    assert recorder.snapshot() == {"spans": {}, "counters": {}}


def test_stage_spans_close_on_an_error_and_pass_marks_on():
    recorder = tracing.SpanRecorder()
    seen = []
    with pytest.raises(RuntimeError):
        with recorder.span("call"), recorder.stage_spans(
            "x", ("a", "b", "c"), lambda name, result: seen.append((name, result))
        ) as mark:
            mark("a", 1)
            raise RuntimeError("in stage b")
    assert seen == [("a", 1)]
    spans = recorder.snapshot()["spans"]
    assert {name: len(s) for name, s in spans.items()} == {"call": 1, "x.a": 1, "x.b": 1}
    assert spans["x.b"][0].parent == "call"
    assert recorder._stack() == []


def test_threads_keep_their_own_parents_and_ids():
    recorder = tracing.SpanRecorder()
    barrier = threading.Barrier(2, timeout=10)

    def work(name):
        with recorder.span(name):
            barrier.wait()
            with recorder.span(name + ".child"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = recorder.snapshot()["spans"]
    for n in ("a", "b"):
        (child,) = spans[n + ".child"]
        assert child.parent == n and child.step == spans[n][0].step
    assert spans["a"][0].step != spans["b"][0].step


# A cascade's stages inside ``train.head_loss`` and ``predict.roi_head``.
CASCADE_TRAIN = {
    "train.stage_head": (3, "train.head_loss"),
    "train.refine": (2, "train.head_loss"),
    "train.stage_match": (2, "train.head_loss"),
    "train.stage_sample": (2, "train.head_loss"),
}
CASCADE_PREDICT = {"predict.stage_head": (3, "predict.roi_head"), "predict.refine": (2, "predict.roi_head")}


def test_cascade_train_step_nests_its_stages_in_head_loss():
    spans = run_step("cascade")["spans"]
    assert set(spans) == set(TRAIN_PARENTS) | set(CASCADE_TRAIN)
    for name, parent in TRAIN_PARENTS.items():
        assert len(spans[name]) == 1 and spans[name][0].parent == parent, name
    (head_loss,) = spans["train.head_loss"]
    children = 0
    for name, (n, parent) in CASCADE_TRAIN.items():
        assert len(spans[name]) == n and all(s.parent == parent for s in spans[name]), name
        assert all(head_loss.start_ns <= s.start_ns <= s.end_ns <= head_loss.end_ns for s in spans[name])
        children += sum(s.end_ns - s.start_ns for s in spans[name])
    assert head_loss.self_ns == head_loss.end_ns - head_loss.start_ns - children
    order = sorted((s.start_ns, name) for name in CASCADE_TRAIN for s in spans[name])
    assert [name for _, name in order] == [
        "train.stage_head", "train.refine", "train.stage_match", "train.stage_sample",
        "train.stage_head", "train.refine", "train.stage_match", "train.stage_sample",
        "train.stage_head",
    ]
    assert len({s.step for ss in spans.values() for s in ss}) == 1


def test_cascade_predict_nests_its_stages_in_roi_head():
    model, cfg = make_model("cascade")
    batch = make_batch("cascade")
    tracing.reset()
    with torch.no_grad():
        pfr.predict(model, cfg, batch["image"], batch["extent"], 0.05)
    spans = tracing.snapshot()["spans"]
    assert set(spans) == {"predict.call", *PREDICT_SPANS, *CASCADE_PREDICT}
    (roi_head,) = spans["predict.roi_head"]
    for name, (n, parent) in CASCADE_PREDICT.items():
        assert len(spans[name]) == n and all(s.parent == parent for s in spans[name]), name
        assert all(roi_head.start_ns <= s.start_ns <= s.end_ns <= roi_head.end_ns for s in spans[name])


def test_cascade_counts_its_last_stages_positives_under_a_profiler():
    model, cfg = make_model("cascade")
    state = pts.init_train_state(model, pts.make_optimizer(model))
    step_fn = pts.make_train_step(cfg, pts.make_lr_schedule("constant", 1e-3, 1, 1))
    batch = make_batch("cascade")
    tracing.reset()
    step_fn(state, batch, torch.Generator().manual_seed(1))
    assert tracing.snapshot()["counters"] == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step_fn(state, batch, torch.Generator().manual_seed(2))
    counter = tracing.snapshot()["counters"]["cascade.stage3_positives"]
    assert counter.n == 2 and 0 < counter.value <= 2 * cfg.roi_pos_quota

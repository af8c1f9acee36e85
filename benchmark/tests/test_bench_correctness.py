"""The comparison that decides ``correct``, driven through the harness's
own run at a small canvas on the CPU (the port's CPU paths are the plain
twins of its kernels): the reference agrees with the program, and the
control (the reference with float8 products in the program's place) and
each fault the cell can have come out not correct."""

import pytest
import torch

from benchmark.lib import compare, scenes
from benchmark.tests import small
from benchmark.traffic import predict as predict_kind, train as train_kind

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def legacy():
    return small.cell("legacy_voc_train_b8")


@pytest.fixture(scope="module")
def fpn_predict():
    return small.cell("fpn_coco_predict_b8")


def test_train_reference_agrees_with_the_program(legacy):
    out = small.run(legacy, SEED)
    assert out["correct"], out["checks"]


def test_predict_reference_agrees_with_the_program(fpn_predict):
    out = small.run(fpn_predict, SEED)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1


def _no_update(prog):
    prog.state.optimizer.step = lambda *a, **k: None


def _half_batch(prog):
    step = prog.step_fn

    def half(state, batch, generator):
        b = batch["image"].shape[0]
        return step(state, {k: v[: b // 2] for k, v in batch.items()}, generator)

    prog.step_fn = half


def _altered_answer(prog):
    dispatch = prog.dispatch

    def altered(images, extents, on_stage=None):
        det = dispatch(images, extents, on_stage)
        return det._replace(labels=torch.where(det.valid, (det.labels + 1) % 90, det.labels))

    prog.dispatch = altered


def _half_images(prog):
    dispatch = prog.dispatch

    def half(images, extents, on_stage=None):
        b = images.shape[0]
        det = dispatch(images[: b // 2], extents[: b // 2], on_stage)
        return type(det)(*(torch.cat([t, torch.zeros_like(t)]) for t in det))

    prog.dispatch = half


@pytest.mark.parametrize("fault", [_no_update, _half_batch], ids=["state_unchanged", "half_batch"])
def test_train_faults_are_not_correct(legacy, fault):
    out = small.run(legacy, SEED, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_altered_answer, _half_images], ids=["answer_altered", "half_batch"])
def test_predict_faults_are_not_correct(fpn_predict, fault):
    out = small.run(fpn_predict, SEED, fault=fault)
    assert not out["correct"], out["checks"]


def test_train_control_is_not_correct(legacy):
    c = legacy
    host = scenes.pool(c.traffic, c.config["canvas"], train_kind.seeds(SEED)["scenes"], "cpu")
    ref = train_kind.reference_readings(c, host, SEED, "cpu")
    fp8 = train_kind.reference_readings(c, host, SEED, "cpu", numerics="fp8")
    ok, checks = compare.judge(compare.train_numbers(fp8, ref), c.spec["limits"])
    assert not ok, checks


def test_predict_control_is_not_correct(fpn_predict):
    c = fpn_predict
    host = scenes.pool(c.traffic, c.config["canvas"], predict_kind.seeds(SEED)["scenes"], "cpu",
                       with_boxes=False)
    ref, _ = predict_kind.reference_detections(c, host, SEED, "cpu", [0, 1])
    fp8, _ = predict_kind.reference_detections(c, host, SEED, "cpu", [0, 1], numerics="fp8")
    flat = lambda d: [img for j in (0, 1) for img in d[j]]  # noqa: E731
    ok, checks = compare.judge(compare.predict_numbers(flat(fp8), flat(ref)), c.spec["limits"])
    assert not ok, checks


def test_matching_counts_missing_and_extra_detections():
    import numpy as np

    box = np.array([[0.1, 0.1, 0.5, 0.5]], np.float32)
    one = (box, np.array([3]), np.array([0.9], np.float32))
    none = (np.zeros((0, 4), np.float32), np.zeros(0, np.int64), np.zeros(0, np.float32))
    assert compare.predict_numbers([one], [one]) == {"unmatched_share": 0.0, "score_gap": 0.0}
    assert compare.predict_numbers([none], [one])["unmatched_share"] == 1.0
    other = (box, np.array([4]), np.array([0.9], np.float32))
    assert compare.predict_numbers([other], [one])["unmatched_share"] == 1.0

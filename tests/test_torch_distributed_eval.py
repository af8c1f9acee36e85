"""The port's eval across ranks: each predicts its rows, the detections
are merged, and the mAP is the one-process mAP.

* Engine, two ranks over gloo (``tests/torch_dist.py``), 5 synthetic
  images at two a batch (the last wrap-padded): VOC (legacy) and COCO
  (ResNet50-FPN, a seeded annotation file) give the one-process eval's
  detections, bit for bit, and its mAP and stats; an eval batch of 3
  over two data ranks is refused as the JAX ``evaluate`` refuses it;
  ``CocoEvaluator.synchronize_between_processes`` merges the ranks'
  predictions.
* CLI: the port's ``test`` with ``--num_devices 2`` (two processes,
  ``--eval_batch_size`` 0: one image a rank) on a tiny VOC tree prints the
  ``--num_devices 1`` run's detection count and mAP, and dumps the same
  detections (its image count includes the wrap-padded copy of the last
  batch, as the JAX CLI's does); with ``--num_devices 2 --model_parallel 2`` (fc6/fc7
  split) it agrees with them under the greedy match of
  test_torch_legacy_predict; and the JAX ``test`` CLI on
  ``make_mesh(2)`` (its ``--num_devices 2``) on the same checkpoint
  reports the same counts and an mAP within 1e-3, as
  tests/test_torch_test_cli.py holds the one-device CLIs.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_dist_workers as w
from tests.test_torch_legacy_predict import assert_detections_match
from tests.test_torch_test_cli import BOX_TOL_PX, _args, _parse, voc_and_checkpoint  # noqa: F401
from tests.torch_dist import run_ranks
from tests.torch_threads import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES = 5


def _equal_detections(a: dict, b: dict):
    assert a.keys() == b.keys()
    for i in a:
        for k in ("boxes", "labels", "scores"):
            np.testing.assert_array_equal(a[i][k], b[i][k], err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_eval")
    coco = w.write_coco_index(w.SyntheticLoader(N_IMAGES, 1), str(tmp / "instances.json"))
    specs = [
        ("eval_job", dict(data_type="voc", n_images=N_IMAGES, batch_size=2)),
        ("eval_job", dict(data_type="coco", n_images=N_IMAGES, batch_size=2, coco_path=coco)),
        ("eval_job", dict(data_type="voc", n_images=N_IMAGES, batch_size=3)),
        ("coco_sync_job", dict(coco_path=coco)),
    ]
    two = run_ranks(w.jobs, 2, tmp / "ranks", specs, timeout=600)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: the CPU products' order follows the threads
    try:
        one = {
            "voc": w.eval_job(0, "voc", N_IMAGES, 1),
            "coco": w.eval_job(0, "coco", N_IMAGES, 1, coco),
        }
    finally:
        torch.set_num_threads(threads)
    return two, one


@pytest.mark.parametrize("data_type,job", [("voc", 0), ("coco", 1)])
def test_two_ranks_give_the_one_process_eval(engine_runs, data_type, job):
    two, one = engine_runs
    want = one[data_type]
    assert want["n_images"] == N_IMAGES and sum(len(d["scores"]) for d in want["detections"].values())
    for rank in range(2):
        got = two[rank][job]
        _equal_detections(got["detections"], want["detections"])
        assert got["map"] == want["map"]
        np.testing.assert_equal(got["stats"], want["stats"])  # NaN AP of a class without gt
        assert got["n_images"] == N_IMAGES + 1  # the wrap-padded last batch's copy


def test_an_indivisible_eval_batch_is_refused(engine_runs):
    two, _ = engine_runs
    for rank in range(2):
        assert "divisible" in two[rank][2], two[rank][2]


def test_coco_evaluator_merges_the_ranks(engine_runs):
    two, _ = engine_runs
    assert two[0][3] == two[1][3] == [0, 1]


def _port_cli(root, ckpt, dump, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", "faster_rcnn_pytorch_tpu_torch.test",
         *[a for a in _args(root, ckpt, dump) if a not in ("--num_devices", "1")], *extra],
        # one thread in every rank of every run: the CPU products' order
        # follows the thread count
        cwd=REPO, env=subprocess_env(FRT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1"),
        capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(dump, "rb") as f:
        return _parse(proc.stdout), pickle.load(f)


@pytest.fixture(scope="module")
def cli_runs(voc_and_checkpoint, tmp_path_factory):  # noqa: F811
    root, ckpt = voc_and_checkpoint
    tmp = tmp_path_factory.mktemp("dist_eval_cli")
    return {
        name: _port_cli(root, ckpt, str(tmp / f"{name}.pkl"), *flags)
        for name, flags in (
            ("one", ("--num_devices", "1")),
            ("two", ("--num_devices", "2")),
            ("tp", ("--num_devices", "2", "--model_parallel", "2")),
        )
    }


def test_test_cli_on_two_ranks_gives_the_one_rank_result(cli_runs):
    (counts, dump), (want_counts, want) = cli_runs["two"], cli_runs["one"]
    # 3 images in batches of 2: the count includes the wrap-padded copy, as
    # the JAX CLI's does (test_jax_test_cli_on_a_two_device_mesh_agrees)
    assert (counts[0], want_counts[0]) == (4, 3)
    assert counts[1:] == want_counts[1:] and want_counts[1] > 0
    _equal_detections(dump["predictions"], want["predictions"])
    assert dump["gts"].keys() == want["gts"].keys()


def test_test_cli_with_model_parallel_agrees(cli_runs):
    (counts, dump), (want_counts, want) = cli_runs["tp"], cli_runs["one"]
    assert counts[:2] == want_counts[:2] and abs(counts[2] - want_counts[2]) <= 1e-3  # data 1
    for img_id, p in dump["predictions"].items():
        assert_detections_match(p, want["predictions"][img_id], box_tol=BOX_TOL_PX)


def test_jax_test_cli_on_a_two_device_mesh_agrees(cli_runs, voc_and_checkpoint, tmp_path, capsys, monkeypatch):  # noqa: F811
    import faster_rcnn_pytorch_tpu.utils.runtime as jax_runtime
    from faster_rcnn_pytorch_tpu.test import main as jax_main

    monkeypatch.setattr(jax_runtime, "setup_runtime", lambda: None)
    root, ckpt = voc_and_checkpoint
    dump = str(tmp_path / "jax.pkl")
    argv = [a for a in _args(root, ckpt, dump) if a not in ("--num_devices", "1")]
    assert jax_main([*argv, "--num_devices", "2"]) == 0
    j_imgs, j_dets, j_map = _parse(capsys.readouterr().out)
    (p_imgs, p_dets, p_map), port = cli_runs["two"]
    assert (p_imgs, p_dets) == (j_imgs, j_dets) and abs(p_map - j_map) <= 1e-3
    with open(dump, "rb") as f:
        want = pickle.load(f)
    for img_id, p in port["predictions"].items():
        assert_detections_match(p, want["predictions"][img_id], box_tol=BOX_TOL_PX)

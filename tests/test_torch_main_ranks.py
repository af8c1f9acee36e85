"""The port's train CLI across processes, and its bfloat16 eval recipe.

The tiny COCO tree of tests/test_torch_fpn_train_cli.py (4 train and 2
val images), ResNet50-FPN (its checkpoints are a third of the legacy
model's), ``--resize 128 --max_size 192 --batch_size 2``, one epoch of
two steps, one thread a rank:

* two hosts: two launches of ``main`` with ``--num_hosts 2 --host_id
  0|1 --coordinator 127.0.0.1:<free port>`` (one process each) end with
  the parameters, bit for bit, and the eval lines of one launch with
  ``--num_devices 2`` (two processes on one host): each rank trains on
  the same images in both (each host's record shard is, here, the rows
  its rank takes of the one host's batches, in the same order) and the
  gradients are averaged alike;
* ``--dtype bfloat16``: ``main``'s per-epoch eval casts a bfloat16 copy
  of the weights, as ``test`` does: its detections and the mAP it logs
  equal those of ``test --test_epoch best`` on the checkpoint it saved,
  and the float32 master weights it saved are the ones it trained.
"""

import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_fpn_train_cli import _args, coco_root  # noqa: F401
from tests.torch_threads import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _main(root, log_dir, *flags):
    return subprocess.Popen(
        [sys.executable, "-m", "faster_rcnn_pytorch_tpu_torch.main",
         *_args(root, log_dir, "fpn"), *flags],
        cwd=REPO, env=subprocess_env(FRT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _finish(procs):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(coco_root, tmp_path_factory):  # noqa: F811
    base = tmp_path_factory.mktemp("main_ranks")
    one_host = _finish([_main(coco_root, str(base / "one_host"), "--num_devices", "2")])[0]
    coordinator = f"127.0.0.1:{_free_port()}"
    hosts = _finish([
        _main(coco_root, str(base / "two_hosts"), "--num_hosts", "2", "--host_id", str(h),
              "--coordinator", coordinator)
        for h in (0, 1)
    ])
    yield base, one_host, hosts
    shutil.rmtree(base, ignore_errors=True)


def _eval_lines(out):
    return re.findall(r"^(epoch \d+: mAP = .*|eval inference: \d+ images .*)$", out, re.M)


def test_two_hosts_give_the_two_process_result(runs):
    base, one_host, (host0, host1) = runs
    assert "devices: 2/2 (data 2 x model 1), hosts: 1" in one_host
    assert "devices: 2/2 (data 2 x model 1), hosts: 2" in host0
    assert "epoch 0" not in host1  # rank 1 prints nothing of its own
    want, got = _eval_lines(one_host), _eval_lines(host0)
    assert len(want) == 2 and [g.split(" in ")[0] for g in got] == [x.split(" in ")[0] for x in want]
    assert want[1] == got[1]  # the mAP line
    a = torch.load(base / "one_host" / "run" / "saves" / "run.0.pt", weights_only=True, mmap=True)
    b = torch.load(base / "two_hosts" / "run" / "saves" / "run.0.pt", weights_only=True, mmap=True)
    assert a["step"] == b["step"] == 2
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k


def test_bfloat16_best_epoch_eval_is_the_test_clis(coco_root, tmp_path, capsys, monkeypatch):  # noqa: F811
    from faster_rcnn_pytorch_tpu_torch.engine import evaluate as evaluate_mod
    from faster_rcnn_pytorch_tpu_torch.main import main as train_main
    from faster_rcnn_pytorch_tpu_torch.test import main as test_main

    seen = []
    plain = evaluate_mod.evaluate

    def spy(model, *args, **kwargs):
        result = plain(model, *args, **kwargs)
        seen.append((result, {k: v.detach().clone() for k, v in model.state_dict().items()}))
        return result

    monkeypatch.setattr(evaluate_mod, "evaluate", spy)
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    log_dir = str(tmp_path / "logs")
    bf16 = ("--dtype", "bfloat16", "--thres", "0.0")
    args = [a for a in _args(coco_root, log_dir, "fpn") if a != "float32"]
    args.remove("--dtype")
    try:
        _bfloat16_recipe(args, bf16, log_dir, tmp_path, capsys, seen, train_main, test_main)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def _bfloat16_recipe(args, bf16, log_dir, tmp_path, capsys, seen, train_main, test_main):
    assert train_main([*args, *bf16]) == 0
    (result, weights), = seen
    # restored after the pass
    assert all(v.dtype == torch.float32 for v in weights.values() if v.is_floating_point())
    train_out = capsys.readouterr().out
    logged = re.search(r"^epoch 0: mAP = ([0-9.]+)$", train_out, re.M).group(1)
    with open(os.path.join(log_dir, "run", "run_log.csv")) as f:
        header, *rows = f.read().splitlines()
    column = header.split(",").index("eval/mAP")
    assert [float(r.split(",")[column]) for r in rows if r.split(",")[column]] == [result["map"]]

    saved = torch.load(os.path.join(log_dir, "run", "saves", "run.best.pt"), weights_only=True)
    for k, v in weights.items():
        assert v.dtype == saved["model"][k].dtype and torch.equal(saved["model"][k], v), k

    dump = str(tmp_path / "test.pkl")
    seen.clear()
    assert test_main([*args, *bf16, "--test_epoch", "best", "--dump_detections", dump]) == 0
    test_out = capsys.readouterr().out
    assert re.search(rf"^mAP = {logged}$", test_out, re.M), test_out
    (want, _), = seen
    assert want["map"] == result["map"] and result["n_images"] == 2
    assert want["detections"].keys() == result["detections"].keys()
    for i, d in result["detections"].items():
        for k in ("boxes", "labels", "scores"):
            np.testing.assert_array_equal(d[k], want["detections"][i][k], err_msg=f"{i} {k}")
    assert sum(len(d["scores"]) for d in want["detections"].values()) > 0

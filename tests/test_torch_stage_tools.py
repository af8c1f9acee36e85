"""The stage tools: each raises without a card unless the CPU is asked
for, and on the CPU at a small canvas the predict tool runs ``predict``
through every stage of either generation, and the train tool splits the
FPN train step into its stages."""

import importlib.util
import pathlib

import pytest
import torch

from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import PREDICT_STAGES
from faster_rcnn_pytorch_tpu_torch.tools import predict_stages
from faster_rcnn_pytorch_tpu_torch.utils.runtime import DEVICE_ENV

SMALL = ["--batches", "1", "--batch", "1", "--canvas", "128", "192", "--dtypes", "float32"]


def test_predict_stages_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        predict_stages.main(["--generation", "legacy", *SMALL])
    assert "rate:" not in capsys.readouterr().out


@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_predict_stages_on_the_cpu_when_asked(generation, monkeypatch, capsys):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert predict_stages.main(["--generation", generation, *SMALL]) == 0
    out = capsys.readouterr().out
    assert "rate:" in out and "profile:" not in out
    stages = next(line for line in out.splitlines() if "ms per image:" in line)
    for name in PREDICT_STAGES:
        assert f" {name}=" in stages


def _train_tool():
    path = pathlib.Path(__file__).parents[1] / "tools" / "torch_train_stages.py"
    spec = importlib.util.spec_from_file_location("torch_train_stages", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_train_stages_raises_without_a_card(monkeypatch, capsys):
    tool = _train_tool()
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        tool.main(["--canvas", "192", "256", "--repeats", "1", "--phases", "rate"])
    assert "img/s" not in capsys.readouterr().out


def test_train_stages_splits_the_fpn_step_on_the_cpu_when_asked(monkeypatch, capsys):
    tool = _train_tool()
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    args = ["--generation", "fpn", "--canvas", "128", "160", "--steps", "2", "--warmup", "1"]
    args += ["--dtypes", "float32"]
    assert tool.main([*args, "--phases", "stages"]) == 0
    out = capsys.readouterr().out
    assert "generation fpn" in out and "profile" not in out
    lines = [line for line in out.splitlines() if line.startswith("stages float32")]
    assert len(lines) == 1  # one split: cuDNN's modes are the card's
    assert "median of steps 2-2" in lines[0]
    names = ("backbone+rpn fwd", "propose+targets", "head+loss fwd", "backward", "sgd", "total")
    for name in (*names, "propose", "rpn match", "rpn labels", "roi match", "roi sample"):
        assert f"{name} " in lines[0]

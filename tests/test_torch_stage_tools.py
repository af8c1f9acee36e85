"""The stage tools: each raises without a card unless the CPU is asked
for, and on the CPU at a small canvas the predict tool runs ``predict``
through every stage of either generation."""

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


def test_train_stages_raises_without_a_card(monkeypatch, capsys):
    path = pathlib.Path(__file__).parents[1] / "tools" / "torch_train_stages.py"
    spec = importlib.util.spec_from_file_location("torch_train_stages", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=DEVICE_ENV):
        tool.main(["--canvas", "192", "256", "--repeats", "1", "--phases", "rate"])
    assert "img/s" not in capsys.readouterr().out

"""``faster_rcnn_pytorch_tpu_torch/tools/shapes_recipe.py`` runs the JAX records' commands.

* For each 25-epoch record of ``ACCURACY_SHAPES.json`` that the tool
  runs (shapes-VOC and shapes-COCO, both generations), ``recipe_argv``
  is the record's ``main`` command with the package renamed: the same
  flags and values, the data root aside, plus ``--seed``.
* ``EpochClock`` reads ``main``'s lines into the per-epoch mAP and, on
  COCO, the evaluator's AP@.50 of the same epoch.
"""

import shlex

import pytest

from faster_rcnn_pytorch_tpu_torch.tools import shapes_recipe as sr


def _flags(argv: list[str]) -> dict:
    pairs = dict(zip(argv[::2], argv[1::2]))
    assert len(pairs) * 2 == len(argv), argv
    pairs.pop("--data_root")
    return pairs


@pytest.mark.parametrize("data", ["voc", "coco"])
@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_recipe_argv_is_the_records_command(data, generation):
    record = sr.jax_record(data, generation, 25)
    main_cmd = record["command"].split("&&")[-1]
    words = shlex.split(main_cmd)
    assert words[:3] == ["python", "-m", "faster_rcnn_pytorch_tpu.main"]
    want = _flags(words[3:])
    want.setdefault("--model_generation", "legacy")
    got = _flags(sr.recipe_argv(generation, "/data", 25, data=data, seed=3))
    got.setdefault("--model_generation", "legacy")
    assert got.pop("--seed") == "3"
    assert got == want
    assert sr.MAKE_DATA[data] in record["command"]


def test_epoch_clock_reads_coco_ap50_beside_the_map():
    clock = sr.EpochClock(steps=2, batch_size=8)
    for line in (
        "epoch 0 [0] lr: 0.0020 (0.0020)  loss: 5.3365 (5.3365)  rpn_cls: 0.69 (0.69) time: 5.9s",
        "epoch 0 total: 0:00:11",
        "  AP@[.5:.95] = 0.025",
        "  AP@.50      = 0.086",
        "epoch 0: mAP = 0.0248",
        "epoch 1 [0] lr: 0.0020 (0.0020)  loss: 1.2 (1.2)  rpn_cls: 0.5 (0.5) time: 0.9s",
        "epoch 1 total: 0:00:10",
        "  AP@.50      = 0.243",
        "epoch 1: mAP = 0.0636",
    ):
        clock.line(line)
    summary = clock.summary()
    assert summary["map_by_epoch"] == [0.0248, 0.0636]
    assert summary["ap50_by_epoch"] == [0.086, 0.243]
    assert summary["losses_logged"] == 2 and summary["losses_finite"]


def test_epoch_clock_has_no_ap50_on_voc():
    clock = sr.EpochClock(steps=2)
    for line in ("epoch 0 [0] lr: 0.001 (0.001)  loss: 4.0 (4.0)  x", "epoch 0 total: 0:00:10", "epoch 0: mAP = 0.1725"):
        clock.line(line)
    assert "ap50_by_epoch" not in clock.summary()

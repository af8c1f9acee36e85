"""The manifest and the files it names: every cell's configuration,
traffic kind and metrics exist, names and units keep the contract's form,
and each configuration's budgets are the port's own."""

import json
import os
import re

import pytest

from benchmark.lib import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.manifest()
BENCH = manifest.BENCH_DIR


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_names_existing_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200
    cell = manifest.cell(w["name"])
    assert cell.spec["config"] == w["config"] and cell.chips == w["chips"]
    assert os.path.isfile(os.path.join(BENCH, "traffic", f"{cell.traffic['kind']}.py"))
    assert cell.per_layer, "a cell reports at least one per-layer metric"
    for m in cell.per_layer:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert all(m["moves"] in names for m in cell.per_layer)
    assert cell.spec["limits"] and all(v > 0 for v in cell.spec["limits"].values())


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MAN[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_budgets_are_the_ports(c):
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model

    conf = manifest.load_json(os.path.join(manifest.ROOT, c["file"]))
    assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []
    _, cfg = build_model(conf["generation"])
    for key, value in conf["budgets"].items():
        assert getattr(cfg, key) == pytest.approx(value), key
    assert c["file"].startswith("benchmark/configs/")

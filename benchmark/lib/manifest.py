"""Cells, configurations and metrics, found by the names in
``BENCHMARK.json``: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<kind>.py``, ``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One workload: its file, its configuration's file, and the metrics
    that the manifest names for it."""

    name: str
    spec: dict
    config: dict
    end_to_end: list
    per_layer: list

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(name: str, root: str = ROOT) -> Cell:
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, reported)]
    return Cell(name, spec, config, e2e, per_layer)


def traffic_module(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> float | None``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

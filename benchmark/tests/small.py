"""A cell of the benchmark cut to a size the CPU runs in seconds, for the
tests: the cell's own files with a small canvas, batch and pool, and
fewer warm-up, profiled and checked steps or calls."""

from __future__ import annotations

import contextlib
import copy
import time
from unittest import mock

import torch

from benchmark.lib import manifest, scenes

CANVAS = {"legacy": [128, 192], "fpn": [128, 160]}
COUNTS = {"POOL": 3, "WARMUP_STEPS": 1, "PROFILE_STEPS": 1, "WARMUP_CALLS": 1, "PROFILE_CALLS": 2,
          "CHECK_CALLS": 2}


def cell(name: str):
    c = manifest.cell(name)
    c.config = dict(c.config, canvas=CANVAS[c.config["generation"]])
    c.spec = copy.deepcopy(c.spec)
    t = c.spec["traffic"]
    t.update(batch=2)
    if "box_counts" in t:
        dense = t["max_gt"] > 100
        t["box_counts"] = {"linspace": [20, 30] if dense else [1, 4]}
        t["max_gt"] = 32 if dense else 8
    return c


def run(c, seed: int = 2**31 + 11, trace: bool = False, fault=None) -> dict:
    kind = manifest.traffic_module(c.traffic["kind"])
    torch.manual_seed(0)
    with contextlib.ExitStack() as stack:
        for module in (scenes, kind):
            for name, value in COUNTS.items():
                if hasattr(module, name):
                    stack.enter_context(mock.patch.object(module, name, value))
        return kind.run(c, seed, 0.5, trace, torch.device("cpu"), time.perf_counter(), fault=fault)

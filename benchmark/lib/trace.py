"""The traced part of a ``--trace 1`` run and the record the per-layer
metrics read.

:class:`Profiled` runs a block under ``torch.profiler`` (CPU and CUDA
activities), exports the Chrome trace to a temporary file under
``TMPDIR``, reads it back and deletes it. What stays is a
:class:`Record`: the device's activities (kernels, copies, memsets) with
their launch times on the host, the benchmark's ``bench.*`` ranges, the
host spans the traffic kind timed, the hand kernels' calls with their
bounds, and the counts the readers divide by.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Record:
    kind: str  # "train" or "predict"
    steps: int = 0  # profiled steps or calls
    images_per_step: int = 0
    window: tuple = (0.0, 0.0)  # the profiled window on the trace's clock, us
    device: list = dataclasses.field(default_factory=list)  # (name, ts, dur, launch_ts)
    ranges: list = dataclasses.field(default_factory=list)  # (name, ts, dur) host
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [ms]
    calls: list = dataclasses.field(default_factory=list)  # (work, bound_s)
    kernel_map: dict = dataclasses.field(default_factory=dict)  # work -> [kernel names]
    unprofiled_img_s: float = 0.0
    flops_per_image: float = 0.0
    peak_flops: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in the window in which some activity ran on the device."""
        lo, hi = self.window
        spans = sorted((max(ts, lo), min(ts + dur, hi)) for _, ts, dur, _ in self.device)
        busy, end = 0.0, lo
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def idle_gaps(self) -> list:
        """``(start_us, seconds)`` of every stretch of the window with
        nothing on the device."""
        lo, hi = self.window
        gaps, end = [], lo
        for _, ts, dur, _ in sorted(self.device, key=lambda d: d[1]):
            if ts > end:
                gaps.append((end, (min(ts, hi) - end) / 1e6))
            end = max(end, ts + dur)
            if end >= hi:
                break
        if end < hi:
            gaps.append((end, (hi - end) / 1e6))
        return gaps

    def range_at(self, t: float) -> str:
        """The innermost ``bench.*`` range open on the host at ``t``."""
        best = None
        for name, ts, dur in self.ranges:
            if ts <= t <= ts + dur and (best is None or dur < best[1]):
                best = (name, dur)
        return best[0] if best else "outside"

    def device_seconds(self, match) -> float:
        return sum(dur for name, _, dur, _ in self.device if match(name)) / 1e6

    def launched_in(self, range_name: str) -> list:
        """Device activities whose launch lies inside a host range named
        ``range_name``."""
        spans = [(ts, ts + dur) for name, ts, dur in self.ranges if name == range_name]
        return [d for d in self.device if d[3] is not None and any(a <= d[3] <= b for a, b in spans)]

    def range_count(self, range_name: str) -> int:
        return sum(1 for name, _, _ in self.ranges if name == range_name)

    def median_span(self, name: str):
        vals = self.spans.get(name)
        return statistics.median(vals) if vals else None

    def breakdown(self) -> dict:
        totals: dict = {}
        for name, _, dur, _ in self.device:
            totals[name] = totals.get(name, 0.0) + dur / 1e6
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:10]
        return {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[self.range_at(t), s] for t, s in gaps],
        }


def parse(trace: dict, record: Record, window_name: str = "bench.window") -> None:
    """Fill ``record`` from a Chrome trace of ``torch.profiler``."""
    launch = {}
    for e in trace["traceEvents"]:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    for e in trace["traceEvents"]:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            record.device.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), launch.get(corr)))
        elif cat == "user_annotation" and e.get("name", "").startswith("bench."):
            record.ranges.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    windows = [(ts, ts + dur) for name, ts, dur in record.ranges if name == window_name]
    if not windows:
        raise RuntimeError(f"the trace holds no {window_name} range")
    start = min(w[0] for w in windows)
    # The window ends when its last device activity does (the block ends
    # in a synchronize), or with the host range, whichever is later.
    end = max(max(w[1] for w in windows), max((ts + d for _, ts, d, lt in record.device
                                               if lt is not None and lt >= start), default=start))
    record.window = (start, end)
    record.device = [d for d in record.device if d[1] + d[2] > start and d[1] < end]


class Profiled:
    """``with Profiled(record): ...`` traces the block (which should open a
    ``bench.window`` range and end in a synchronize) into ``record``."""

    def __init__(self, record: Record):
        self.record = record
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        parse(trace, self.record)
        return False


class Range:
    """A ``bench.*`` range opened and closed by callbacks (hooks), not by a
    ``with`` block."""

    def __init__(self, name: str):
        self.name = name
        self.ctx = None

    def open(self):
        if self.ctx is None:
            self.ctx = torch.profiler.record_function(self.name)
            self.ctx.__enter__()

    def close(self):
        if self.ctx is not None:
            self.ctx.__exit__(None, None, None)
            self.ctx = None

"""Metrics, logging and tracing of the train loop.

Counterpart of ``faster_rcnn_pytorch_tpu/utils/logging.py``: smoothed
console step logs with an ETA (:class:`MetricLogger`), TensorBoard and
CSV scalars (:class:`ScalarWriter`), images/s counters
(:class:`StepTimer`), a ``torch.profiler`` trace around a block
(:func:`trace_context`) and the program's own spans and counters
(:class:`SpanRecorder`). :func:`is_main` is global rank 0: with several
ranks (``parallel/mesh.py``) only it prints step logs and writes scalars.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import datetime
import itertools
import os
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch


def is_main() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def print0(*args, **kwargs) -> None:
    if is_main():
        print(*args, **kwargs)


class SmoothedValue:
    """Windowed and global average of a scalar series."""

    def __init__(self, window: int = 20):
        self.deque: collections.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return f"{self.avg:.4f} ({self.global_avg:.4f})"


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """Yield ``(i, item)``, printing the smoothed meters and an ETA
        every ``print_freq`` steps and at the last step."""
        start = time.time()
        iter_time = SmoothedValue()
        n = len(iterable) if hasattr(iterable, "__len__") else None
        last = time.time()
        for i, obj in enumerate(iterable):
            yield i, obj
            iter_time.update(time.time() - last)
            last = time.time()
            if is_main() and (i % print_freq == 0 or (n and i == n - 1)):
                eta = ""
                if n:
                    eta_sec = iter_time.global_avg * (n - i - 1)
                    eta = f" eta: {datetime.timedelta(seconds=int(eta_sec))}"
                total = f"/{n}" if n else ""
                print(f"{header} [{i}{total}]{eta} {self} time: {iter_time.avg:.3f}s", flush=True)
        print0(f"{header} total: {datetime.timedelta(seconds=int(time.time() - start))}")


class ScalarWriter:
    """TensorBoard (``backend="tensorboard"``) and CSV scalar sink. The CSV
    ``{log_dir}/{name}/{name}_log.csv`` is always written, by global rank 0
    only: on the other ranks the writer drops every scalar."""

    def __init__(self, log_dir: str, name: str, backend: str = "tensorboard"):
        self.dir = os.path.join(log_dir, name)
        self.csv_path = os.path.join(self.dir, f"{name}_log.csv")
        self._tb = None
        self._csv_rows: dict[str, dict] = {}
        self._last_flush = 0.0
        self._on = is_main()
        if not self._on:
            return
        os.makedirs(self.dir, exist_ok=True)
        if backend == "tensorboard":
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self._on:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        row = self._csv_rows.setdefault(str(step), {"step": step})
        row[tag] = float(value)
        # The CSV is rewritten whole (its columns can grow mid-run), so
        # flushes are throttled to one per 2 s, plus close().
        if time.time() - self._last_flush >= 2.0:
            self._flush_csv()

    def _flush_csv(self) -> None:
        self._last_flush = time.time()
        rows = sorted(self._csv_rows.values(), key=lambda r: r["step"])
        cols: list[str] = ["step"]
        for r in rows:
            cols += [k for k in r if k not in cols]
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            w.writerows(rows)

    def close(self) -> None:
        if self._csv_rows:
            self._flush_csv()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def trace_context(log_dir: str, enabled: bool = False):
    """``torch.profiler`` trace (CPU, plus CUDA when a card is present)
    around a block, written as a Chrome trace to ``log_dir/trace.json``.
    The trace holds the program's ``frcnn.*`` ranges (:class:`SpanRecorder`)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The last spans kept of each name: a 20 s window holds some 200 train
# steps or 350 predict calls.
SPANS_KEPT = 4096


class Span(NamedTuple):
    """One closed span of :class:`SpanRecorder`."""

    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: str | None  # the name of the span open around it
    step: int  # shared by every span of one train step or predict call
    self_ns: int  # the duration less what its child spans cover
    profiled: bool  # a torch.profiler recorded it


class Counter(NamedTuple):
    """A counter of :class:`SpanRecorder`: its sum over ``n`` items."""

    value: float
    n: int


def profiling() -> bool:
    """Whether a ``torch.profiler`` records (a flag read, 0.15 us)."""
    return torch.autograd.profiler._is_profiler_enabled


class _OpenSpan:
    __slots__ = ("recorder", "name", "parent", "step", "start", "child_ns", "range")

    def __init__(self, recorder: "SpanRecorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        stack = self.recorder._stack()
        if stack:
            self.parent, self.step = stack[-1].name, stack[-1].step
        else:
            self.parent, self.step = None, next(self.recorder._ids)
        self.child_ns = 0
        self.range = None
        if profiling():
            self.range = torch.profiler.record_function("frcnn." + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = self.recorder._stack()
        stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        took = end - self.start
        if stack:
            stack[-1].child_ns += took
        spans = self.recorder._spans.get(self.name)
        if spans is None:
            spans = self.recorder._spans.setdefault(self.name, collections.deque(maxlen=SPANS_KEPT))
        spans.append(
            (self.start, end, self.parent, self.step, took - self.child_ns, self.range is not None)
        )
        return False


class _StageSpans:
    """The spans ``<prefix>.<stage>`` of a chain of ``on_stage`` marks: the
    first opens on entry, each mark closes the stage that ended, calls the
    caller's ``on_stage`` with the same arguments and opens the next."""

    def __init__(self, recorder, prefix: str, stages, on_stage):
        self.recorder, self.stages, self.on_stage = recorder, tuple(stages), on_stage
        self.names = tuple(f"{prefix}.{s}" for s in self.stages)
        self.current = None

    def _open(self, i: int) -> None:
        if i < len(self.names):
            self.current = self.recorder.span(self.names[i])
            self.current.__enter__()

    def mark(self, name: str, result) -> None:
        if self.current is not None:
            self.current.__exit__(None, None, None)
            self.current = None
        if self.on_stage is not None:
            self.on_stage(name, result)
        self._open(self.stages.index(name) + 1)

    def __enter__(self):
        self._open(0)
        return self.mark

    def __exit__(self, *exc):
        if self.current is not None:
            self.current.__exit__(*exc)
            self.current = None
        return False


class SpanRecorder:
    """The program's spans and counters, kept in memory.

    A span (:meth:`span`) always takes two reads of the host clock and
    records its name, start, end, parent, step id and self time; the
    last :data:`SPANS_KEPT` spans of each name stay. While a
    ``torch.profiler`` records, a span also opens the range ``frcnn.<name>``, so the
    program's stages sit on the profiler's timeline, and counters
    (:meth:`count`) add up on the device with no sync; with no profiler
    they cost nothing. A span opened with none open around it (on its
    thread) starts a new step id. :meth:`snapshot` reads everything
    (syncing for the counters), :meth:`reset` empties it.
    """

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count()
        self._spans: dict[str, collections.deque] = {}
        self._counters: dict[str, list] = {}

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str) -> _OpenSpan:
        """``with recorder.span(name): ...``"""
        return _OpenSpan(self, name)

    def stage_spans(
        self, prefix: str, stages, on_stage: Callable[[str, object], None] | None = None
    ):
        """``with recorder.stage_spans(prefix, stages, on_stage) as mark``:
        ``mark`` is the ``on_stage`` to hand to a function whose marks end
        each of ``stages`` in order (:class:`_StageSpans`)."""
        return _StageSpans(self, prefix, stages, on_stage)

    def count(self, name: str, value: torch.Tensor, n: int) -> None:
        """Add ``value.sum()`` over ``n`` items to the counter ``name``,
        while a profiler records."""
        if not profiling():
            return
        total = value.sum()
        entry = self._counters.get(name)
        if entry is None:
            self._counters[name] = [total, n]
        else:
            entry[0] = entry[0] + total
            entry[1] += n

    def snapshot(self) -> dict:
        """``{"spans": {name: [Span]}, "counters": {name: Counter}}``."""
        return {
            "spans": {name: [Span(name, *s) for s in q] for name, q in list(self._spans.items())},
            "counters": {
                name: Counter(float(v), n) for name, (v, n) in list(self._counters.items())
            },
        }

    def reset(self) -> None:
        self._spans = {}
        self._counters = {}


# The process's recorder: the program's spans are read after the work
# (the benchmark, a test) without a handle being passed down the calls.
RECORDER = SpanRecorder()
span = RECORDER.span
stage_spans = RECORDER.stage_spans
count = RECORDER.count
snapshot = RECORDER.snapshot
reset = RECORDER.reset


class StepTimer:
    """Step-time list with a p50. A caller timing
    device work synchronises before :meth:`stop`."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def p50(self) -> float:
        return float(np.percentile(self.times, 50)) if self.times else 0.0

"""Metrics, logging and tracing of the train loop.

Counterpart of ``faster_rcnn_pytorch_tpu/utils/logging.py``: smoothed
console step logs with an ETA (:class:`MetricLogger`), TensorBoard and
CSV scalars (:class:`ScalarWriter`), images/s counters
(:class:`StepTimer`) and a ``torch.profiler`` trace around a block
(:func:`trace_context`). :func:`is_main` is global rank 0: with several
ranks (``parallel/mesh.py``) only it prints step logs and writes scalars.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import datetime
import os
import time

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
    around a block, written as a Chrome trace to ``log_dir/trace.json``."""
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

"""The program's own spans and counters, read after the run.

The port records a span around each stage of its train step and of
``predict`` (``faster_rcnn_pytorch_tpu_torch/utils/logging.py``: name,
host clock start and end, parent, the step or call's id, self time, and
whether a profiler recorded it), and counts the class NMS's candidates
while a profiler records. This module and ``program.py`` are the two
harness modules that import the port. A program without that recorder
gives ``None`` here, and the metrics that read it are left out.
"""

from __future__ import annotations

import statistics


def snapshot():
    """The recorder's ``snapshot()``, or ``None`` where the program has none."""
    try:
        from faster_rcnn_pytorch_tpu_torch.utils import logging
    except ImportError:
        return None
    read = getattr(logging, "snapshot", None)
    return read() if read is not None else None


def host_ms(name: str):
    """The median, over the steps or calls that no profiler recorded, of
    each one's summed self time of the span ``name`` (a step's
    micro-batches add up), in ms; ``None`` where no such span was
    recorded."""
    snap = snapshot()
    spans = snap["spans"].get(name) if snap else None
    per_step: dict = {}
    for s in spans or ():
        if not s.profiled:
            per_step[s.step] = per_step.get(s.step, 0) + s.self_ns
    return statistics.median(per_step.values()) / 1e6 if per_step else None


def per_item(name: str):
    """The counter ``name``'s sum over the items it counted, or ``None``."""
    snap = snapshot()
    counter = snap["counters"].get(name) if snap else None
    return counter.value / counter.n if counter and counter.n else None

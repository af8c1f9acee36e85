"""Host spans and ``bench.*`` ranges opened from forward hooks on the
program's modules, with no change to the program.

The configuration's ``modules`` names the backbone, the RPN head and the
RoI head by their attribute paths in the model. Around each module's
forward the hooks open a range of its name; from the end of the RPN
head's last forward to the start of the RoI head's they time the host's
``propose_targets`` span (propose, the train targets and the RoI op's
dispatch) and, when ranges are on, hold a ``bench.propose_targets``
range over it.
"""

from __future__ import annotations

import time

from benchmark.lib.trace import Range


def _module(model, path: str):
    for part in path.split("."):
        model = model[part] if hasattr(model, "keys") and part in model.keys() else getattr(model, part)
    return model


class ModuleSpans:
    def __init__(self, model, modules: dict, spans: dict, ranges: bool):
        self.model, self.modules, self.spans, self.ranges = model, modules, spans, ranges
        self.handles = []
        self.rpn_end = None
        self.pt = Range("bench.propose_targets")
        self.open = {}

    def __enter__(self):
        for role in ("backbone", "rpn_head", "roi_head"):
            m = _module(self.model, self.modules[role])
            self.handles.append(m.register_forward_pre_hook(lambda mod, args, r=role: self._pre(r)))
            self.handles.append(m.register_forward_hook(lambda mod, args, out, r=role: self._post(r)))
        return self

    def _pre(self, role):
        if role == "rpn_head":
            self.rpn_end = None
        if self.ranges:
            self.pt.close()
        if role == "roi_head" and self.rpn_end is not None:
            self.spans.setdefault("propose_targets", []).append((time.perf_counter() - self.rpn_end) * 1e3)
            self.rpn_end = None
        if self.ranges:
            self.open[role] = Range(f"bench.{role}")
            self.open[role].open()

    def _post(self, role):
        if self.ranges:
            self.open.pop(role).close()
        if role == "rpn_head":
            self.rpn_end = time.perf_counter()
            if self.ranges:
                self.pt.open()

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.pt.close()
        return False


class StageRanges:
    """``predict``'s ``on_stage`` marks as a chain of ``bench.<stage>``
    ranges: each mark closes the range of the stage that ended and opens
    the next stage's."""

    def __init__(self, stages):
        self.stages = list(stages)
        self.current = None

    def start(self):
        self.current = Range(f"bench.{self.stages[0]}")
        self.current.open()

    def __call__(self, name, result):
        self.current.close()
        i = self.stages.index(name)
        self.current = Range(f"bench.{self.stages[i + 1]}") if i + 1 < len(self.stages) else None
        if self.current is not None:
            self.current.open()

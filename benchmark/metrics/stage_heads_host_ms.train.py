"""Median host self time a train step of the program's three
``train.stage_head`` spans, summed: each cascade stage's RoI align, fc
layers and loss terms (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.stage_head")

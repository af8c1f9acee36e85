"""Median host self time a train step of the program's
``train.stage_sample`` spans, summed: the sampling and regression
targets of the cascade's later stages (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.stage_sample")

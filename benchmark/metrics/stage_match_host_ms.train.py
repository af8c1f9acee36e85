"""Median host self time a train step of the program's
``train.stage_match`` spans, summed: the IoU match of the cascade's later
stages, refined boxes and gt against the gt (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.stage_match")

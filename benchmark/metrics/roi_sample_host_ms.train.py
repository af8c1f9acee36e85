"""Median host self time a train step of the program's ``train.roi_sample``
span: each image's RoI sampling and regression targets, an image at a
time (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.roi_sample")

"""Median host self time a train step of the program's ``train.forward``
span: the backbone's and the RPN head's forward (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.forward")

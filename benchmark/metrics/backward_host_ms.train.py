"""Median host self time a train step of the program's ``train.backward``
span: ``loss.backward()`` (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.backward")

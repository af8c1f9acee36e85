"""Median host self time a train step of the program's ``train.rpn_labels``
span: each image's RPN labels and their sampling, an image at a time
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.rpn_labels")

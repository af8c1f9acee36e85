"""Median host self time a train step of the program's ``train.rpn_match``
span: the anchors' inside mask and the batch's anchor match
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.rpn_match")

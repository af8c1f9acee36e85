"""Median host self time a train step of the program's ``train.head_loss``
span: the RoI head on the sampled rois and the four-part loss
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.head_loss")

"""Median host self time a train step of the program's ``train.roi_match``
span: the candidate rois and the batch's IoU match against the gt
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.roi_match")

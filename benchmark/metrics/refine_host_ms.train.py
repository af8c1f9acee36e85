"""Median host self time a train step of the program's ``train.refine``
spans, summed: the cascade's decode of each stage's sampled rois by its
detached deltas, the clip and the next candidates (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.host_ms("train.refine")

"""Median host self time a predict call of the program's
``predict.class_nms`` span: the per-class threshold and NMS of the batch
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "predict":
        return None
    return program_spans.host_ms("predict.class_nms")

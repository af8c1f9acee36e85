"""The (class, roi) pairs an image whose score clears the threshold, as
the program's counter ``class_nms.candidates`` counts them in the class
NMS: over the traced calls, the only ones a counter runs in
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "predict":
        return None
    return program_spans.per_item("class_nms.candidates")

"""The sampled positives an image at the cascade's last stage, as the
program's counter ``cascade.stage3_positives`` counts them: over the
traced steps, the only ones a counter runs in (``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "train":
        return None
    return program_spans.per_item("cascade.stage3_positives")

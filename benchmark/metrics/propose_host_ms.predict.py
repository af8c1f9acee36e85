"""Median host self time a predict call of the program's
``predict.propose`` span: the test-budget proposals of the batch
(``lib/program_spans.py``)."""

from benchmark.lib import program_spans


def read(record):
    if record.kind != "predict":
        return None
    return program_spans.host_ms("predict.propose")

"""Median host time from the start of a train step's call (after its
batch is on the device) until the call returns, before any sync: the
host's dispatch of one step."""


def read(record):
    if record.kind != "train":
        return None
    return record.median_span("dispatch")

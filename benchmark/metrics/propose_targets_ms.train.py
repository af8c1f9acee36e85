"""Median host time of a train step from the end of the RPN head's last
forward to the start of the RoI head's (propose, the train targets and
the RoI op's dispatch), from the benchmark's forward hooks."""


def read(record):
    if record.kind != "train":
        return None
    return record.median_span("propose_targets")

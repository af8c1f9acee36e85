"""Device time per predict call of the kernels launched between
``predict``'s ``decode`` and ``class_nms`` marks (the benchmark's
``bench.class_nms`` range)."""


def read(record):
    if record.kind != "predict":
        return None
    calls = record.range_count("bench.class_nms")
    if not calls:
        return None
    return 1e3 * sum(dur for _, _, dur, _ in record.launched_in("bench.class_nms")) / 1e6 / calls

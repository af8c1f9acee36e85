"""The share of the traced window with no kernel, copy or memset on the
device (predict cells), from the profiler's device timeline."""


def read(record):
    if record.kind != "predict" or record.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.busy_s() / record.window_s)

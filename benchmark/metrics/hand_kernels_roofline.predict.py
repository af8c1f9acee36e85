"""The port's hand kernels in the traced predict steps: the sum of each
call's bound (``roofline/work.py``, from the call's arguments) over the
sum of the device time of the kernels ``roofline/kernels/`` maps to
those calls."""

import re


def read(record):
    if record.kind != "predict" or not record.calls:
        return None
    names = {k for ks in record.kernel_map.values() for k in ks}
    pattern = re.compile(r"\b(" + "|".join(sorted(names)) + r")\b")
    spent = record.device_seconds(lambda name: pattern.search(name) is not None)
    if spent <= 0:
        return None
    return 100.0 * sum(bound for _, bound in record.calls) / spent

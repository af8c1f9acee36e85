"""The least work each hand kernel's call needs, from its arguments'
shapes alone: ``(operations, bytes)``, and the bound that follows.

Each work item is a module ``kernels/<item>.py``: ``FUNCTION``, the
program's Python wrapper that launches the kernel (``module:function``),
``KERNELS``, the CUDA kernel names it launches, and ``count(*args)``,
which takes the wrapper's own arguments. Each input byte is counted read
once and each output byte written once; data-dependent work (how many
boxes intersect, how many cells a roi's samples touch) is not counted,
so the bound is a lower one whatever implements the call.
"""

from __future__ import annotations

import importlib
import json
import os
import pkgutil

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "peaks.json")) as _f:
    PEAKS = json.load(_f)

# IoU of a pair: 4 max/min, 2 subtractions, 2 clamps, a product, the
# union's 3 adds and a division, as PERF.md's kernel table counts it.
IOU_OPS = 14


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def dtype_size(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def bound_seconds(ops: float, nbytes_: float) -> float:
    """The least time: the larger of the operations at the float32 peak
    of the CUDA cores and the bytes at the memory's rate."""
    return max(ops / PEAKS["fp32_flops"], nbytes_ / PEAKS["hbm_bytes_per_s"])


def items() -> dict:
    """``{item: module}`` of every work item under ``kernels/``."""
    out = {}
    for info in pkgutil.iter_modules([os.path.join(_HERE, "kernels")]):
        out[info.name] = importlib.import_module(f"benchmark.roofline.kernels.{info.name}")
    return out


def kernel_map() -> dict:
    return {item: list(mod.KERNELS) for item, mod in items().items()}

"""Hand-written CUDA kernels of the port, built at first use.

The sources live next to this file. :func:`extension` compiles them with
``torch.utils.cpp_extension.load`` for Hopper (``sm_90a``) into
``build/torch_kernels/`` at the root of the checkout, once per process,
and returns the loaded module. Nothing here runs at import time: the CPU
tests import every module, and this host may have no ``nvcc``.
"""

from __future__ import annotations

import os
import threading

_SOURCES = (
    "roi_pool.cu", "roi_align.cu", "roi_align_slots.cu", "iou.cu", "nms.cu", "anchor_match.cu",
    "frozen_bn.cu",
    "binding.cpp",
)
_BUILD_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    ),
    "build",
    "torch_kernels",
)
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_ext = None
_lock = threading.Lock()


def extension():
    """The compiled kernel module (builds it on the first call; a build
    failure raises)."""
    global _ext
    if _ext is not None:  # every launch asks: no lock once it is built
        return _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(_BUILD_DIR, exist_ok=True)
            here = os.path.dirname(os.path.abspath(__file__))
            _ext = load(
                name="frcnn_torch_kernels",
                sources=[os.path.join(here, s) for s in _SOURCES],
                build_directory=_BUILD_DIR,
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS),
            )
        return _ext

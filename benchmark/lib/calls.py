"""The hand kernels' calls in the traced steps, each with its bound.

Each work item of ``roofline/kernels/`` names the program's Python
wrapper that launches its kernel (``module:function``). Inside
:class:`KernelCalls` every such wrapper is replaced, on its module, by one
that appends ``(work, bound seconds)`` from the item's ``count`` and
calls the original; on exit the originals are put back. Nothing of the
program changes on disk, and the wrappers read only shapes (no sync).
"""

from __future__ import annotations

import functools
import importlib

from benchmark.roofline import work


class KernelCalls:
    def __init__(self, calls: list):
        self.calls = calls
        self.patched = []

    def __enter__(self):
        for item, spec in work.items().items():
            mod_name, fn_name = spec.FUNCTION.split(":")
            mod = importlib.import_module(mod_name)
            original = getattr(mod, fn_name)
            counter = spec.count

            @functools.wraps(original)
            def wrapper(*args, _item=item, _orig=original, _count=counter, **kwargs):
                ops, nbytes = _count(*args, **kwargs)
                self.calls.append((_item, work.bound_seconds(ops, nbytes)))
                return _orig(*args, **kwargs)

            if hasattr(original, "launches"):
                wrapper.launches = original.launches
            setattr(mod, fn_name, wrapper)
            self.patched.append((mod, fn_name, original, wrapper))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, original, wrapper in reversed(self.patched):
            if hasattr(original, "launches"):
                original.launches = wrapper.launches
            setattr(mod, fn_name, original)
        self.patched = []
        return False

"""Model FLOPs of a step from the convolution and linear shapes that
forward hooks see.

A forward costs ``2 * outputs * (in_channels / groups) * kh * kw`` for a
convolution and ``2 * rows * in * out`` for a linear layer. A train step
adds, for each layer the backward reaches, the same again for the input
gradient (when the input needs one) and for the weight gradient (when
the weight needs one); the FPN's frozen stem and ``layer1`` are detached,
so the backward never reaches them. Element-wise work, the RoI ops and
NMS are not model FLOPs.
"""

from __future__ import annotations

import math

from torch import nn


def forward_flops(module: nn.Module, out_shape) -> int:
    if isinstance(module, nn.Conv2d):
        kh, kw = module.kernel_size
        return 2 * math.prod(out_shape) * (module.in_channels // module.groups) * kh * kw
    if isinstance(module, nn.Linear):
        return 2 * math.prod(out_shape) * module.in_features
    raise TypeError(type(module))


class StepFlops:
    """``with StepFlops(model) as f: <one step>``, then ``f.total``."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.handles = []
        self.calls = []  # [fwd, input_grad, weight_grad, reached]

    def __enter__(self):
        for m in self.model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                self.handles.append(m.register_forward_hook(self._hook))
        return self

    def _hook(self, module, inputs, output):
        x = inputs[0]
        entry = [forward_flops(module, output.shape), x.requires_grad, module.weight.requires_grad, False]
        self.calls.append(entry)
        if output.requires_grad:
            def reached(grad, entry=entry):
                entry[3] = True
            output.register_hook(reached)

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []
        return False

    @property
    def total(self) -> int:
        out = 0
        for fwd, in_grad, w_grad, reached in self.calls:
            out += fwd
            if reached:
                out += fwd * (int(in_grad) + int(w_grad))
        return out

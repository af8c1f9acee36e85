"""FrozenBatchNorm2d with, where the site has them, the residual add and the
ReLU, as one pass over an NCHW activation.

The eager chain (:func:`frozen_bn_reference`, what ``models/resnet.py``
ran before it had this op) is ``(x - mean) * inv + bias`` with the three
per-channel vectors cast to the activations' dtype, then ``+ residual``
and ``relu`` where the site has them: three broadcast kernels and up to
two more, each a full pass over the activation. The hand-written kernel
(``ops/cuda/frozen_bn.cu``) does it in one pass, bit for bit: the same
operations in the same order, each rounded to the activations' dtype as
PyTorch rounds them. Its gradient is one pass too: the ReLU's mask on the
site's output (``threshold_backward``'s rule), times ``inv``, and at a
site with a residual the masked gradient handed to the residual branch,
as the chain's add hands it.

:func:`frozen_bn` dispatches as ``ops/roi_align.py`` does: an autograd
function when an input needs a gradient, else the ``frcnn::frozen_bn`` op
(``ops/library.py``), which ``torch.export`` traces and an exported
program calls. A CUDA tensor runs the kernels, a CPU tensor the eager
chain and its plain backward (``ops/library.py::use_kernel``). ``inv``
is the caller's float32 ``rsqrt(var + eps) * weight``
(``models/resnet.py::FrozenBatchNorm2d``); the vectors take no gradient.
"""

from __future__ import annotations

import torch

from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension
from faster_rcnn_pytorch_tpu_torch.ops.library import use_kernel  # also registers frcnn::*


def _col(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype)[None, :, None, None]


def frozen_bn_reference(x, mean, inv, bias, residual=None, relu: bool = False) -> torch.Tensor:
    """The eager chain: ``x [B, C, H, W]``, ``mean``, ``inv``, ``bias``
    ``[C]`` -> ``(x - mean) * inv + bias`` (each vector cast to ``x``'s
    dtype), ``+ residual`` where given, then ``relu`` where asked."""
    y = (x - _col(mean, x.dtype)) * _col(inv, x.dtype) + _col(bias, x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def frozen_bn_backward_reference(grad, out, inv, residual_grad: bool):
    """The eager chain's backward: ``grad`` of the site's output, ``out``
    that output (a ReLU site) or None -> ``(dx, dresidual)``: the ReLU's
    mask (``threshold_backward``: zero where ``out <= 0``), times ``inv``
    cast to the gradient's dtype; ``dresidual`` is the masked gradient
    where ``residual_grad``, else None."""
    if out is not None:
        grad = torch.ops.aten.threshold_backward(grad, out, 0)
    return grad * _col(inv, grad.dtype), (grad if residual_grad else None)


def frozen_bn_cuda(x, mean, inv, bias, residual=None, relu: bool = False) -> torch.Tensor:
    """The hand-written Hopper kernel (``ops/cuda/frozen_bn.cu``), same
    arguments and result as :func:`frozen_bn_reference` (the binding checks
    them and raises on what the kernel does not take). Counts its launches
    in ``frozen_bn_cuda.launches``."""
    out = extension().frozen_bn_forward(x, mean, inv, bias, residual, relu)
    frozen_bn_cuda.launches += 1
    return out


frozen_bn_cuda.launches = 0


def frozen_bn_backward_cuda(grad, out, inv, residual_grad: bool):
    """The hand-written Hopper backward, same arguments and result as
    :func:`frozen_bn_backward_reference`. Counts its launches in
    ``frozen_bn_backward_cuda.launches``."""
    dx, dresidual = extension().frozen_bn_backward(grad, out, inv, residual_grad)
    frozen_bn_backward_cuda.launches += 1
    return dx, dresidual


frozen_bn_backward_cuda.launches = 0


class _FrozenBN(torch.autograd.Function):
    """The site with its gradient in ``x`` and the residual. A ReLU site
    keeps its output for the mask, as the chain's ReLU does; the vectors
    get no gradient (they are buffers). The backward takes the path the
    forward took."""

    @staticmethod
    def forward(ctx, x, mean, inv, bias, residual, relu):
        ctx.kernel = use_kernel(x, "FrozenBN")
        forward = frozen_bn_cuda if ctx.kernel else frozen_bn_reference
        out = forward(x, mean, inv, bias, residual, relu)
        ctx.residual_grad = residual is not None and ctx.needs_input_grad[4]
        ctx.save_for_backward(out if relu else None, inv)
        return out

    @staticmethod
    def backward(ctx, grad):
        out, inv = ctx.saved_tensors
        backward = frozen_bn_backward_cuda if ctx.kernel else frozen_bn_backward_reference
        dx, dresidual = backward(grad, out, inv, ctx.residual_grad)
        return dx, None, None, None, dresidual, None


def frozen_bn(x, mean, inv, bias, residual=None, relu: bool = False) -> torch.Tensor:
    """``x [B, C, H, W]``, float32 ``mean``, ``inv`` and ``bias`` ``[C]``,
    ``residual`` like ``x`` or None -> ``relu?((x - mean) * inv + bias (+
    residual))`` in ``x``'s dtype, differentiable in ``x`` and the
    residual: :func:`frozen_bn_reference`'s values, one pass. The sites are
    the model's three kinds, BN, BN + ReLU and BN + residual + ReLU: a
    residual without ``relu`` raises, on every device."""
    if residual is not None and not relu:
        raise ValueError("frozen_bn: a site with a residual has a ReLU")
    if torch.is_grad_enabled() and (
        x.requires_grad or (residual is not None and residual.requires_grad)
    ):
        return _FrozenBN.apply(x, mean, inv, bias, residual, relu)
    return torch.ops.frcnn.frozen_bn(x, mean, inv, bias, residual, relu)

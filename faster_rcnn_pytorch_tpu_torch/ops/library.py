"""Which implementation of a port op runs, and the forward kernels that
``predict`` runs as ``torch.library`` ops.

:func:`use_kernel` is the one dispatch rule of ``ops/``: a CUDA tensor runs
the hand kernel, a CPU tensor the plain version, any other device raises.
Every dispatch of the kernel modules asks it. :func:`plain_versions`
(tests and ``chip_smoke.py`` only) makes it answer "plain version" on
every device while it is open, so that a test can hold a whole model's
kernels against their plain versions.

The kernels are bound to Python through ``PYBIND11_MODULE``
(``ops/cuda/binding.cpp``), which ``torch.export`` cannot trace. Each op
below is opaque to the tracer instead: its fake (meta) implementation gives
only the output shapes, and an exported program calls the op by name
(``torch.ops.frcnn.*``), which runs the Python implementation registered
here (a contiguous tensor, as the fakes describe): the kernel's wrapper,
which counts its launches (``roi_pool_cuda.launches`` and the others)
whether the caller is eager code or an exported program, or the plain
version, as :func:`use_kernel` says.

* ``frcnn::roi_pool``: RoIPool forward without the argmax
  (``ops/roi_pool.py``);
* ``frcnn::multiscale_roi_align``: MultiScaleRoIAlign forward over P2..P5
  (``ops/roi_align.py``);
* ``frcnn::nms_segments``: segmented exact greedy NMS (``ops/nms.py``);
* ``frcnn::frozen_bn``: FrozenBatchNorm2d with its residual add and ReLU
  (``ops/frozen_bn.py``), 53 calls a ResNet50 forward. It is defined
  through ``torch.library.Library``, whose Python kernels cost under half
  of ``custom_op``'s host time a call.

Import this module before ``torch.export.load`` reads an artifact that
calls them (``serving.load_artifact`` does). The implementations import
their modules when called, so the kernel modules may import this one.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import Tensor

_PLAIN = contextvars.ContextVar("frcnn_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """For tests and ``chip_smoke.py`` only: inside the ``with``, every op
    of the port runs its plain version, on every device. Restored on exit,
    also on an exception. An autograd function's backward takes the path
    its forward took (autograd runs a CUDA backward on a thread of its
    own, which does not see the switch)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t: Tensor, what: str) -> bool:
    """Whether the ``what`` op runs its hand kernel on ``t``: True on a CUDA
    tensor, False on a CPU tensor and inside :func:`plain_versions`; any
    other device raises."""
    if t.is_cuda:
        return not _PLAIN.get()
    if t.device.type == "cpu" or _PLAIN.get():
        return False
    raise NotImplementedError(f"no {what} kernel for {t.device}")


@torch.library.custom_op("frcnn::roi_pool", mutates_args=())
def roi_pool(features: Tensor, rois: Tensor, spatial_scale: float, output_size: int) -> Tensor:
    """``features [B, C, h, w]``, ``rois [B, n, 4]`` -> ``[B, n, C, P, P]``."""
    from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as mod

    if use_kernel(features, "RoIPool"):
        return mod.roi_pool_cuda(features, rois, spatial_scale, output_size)
    return mod.roi_pool_reference(features, rois, spatial_scale, output_size).contiguous()


@roi_pool.register_fake
def _roi_pool_fake(features, rois, spatial_scale, output_size):
    b, c = features.shape[:2]
    return features.new_empty((b, rois.shape[1], c, output_size, output_size))


@torch.library.custom_op("frcnn::multiscale_roi_align", mutates_args=())
def multiscale_roi_align(features: list[Tensor], rois: Tensor, level: Tensor) -> Tensor:
    """P2..P5 ``[B, C, h_l, w_l]``, ``rois [B, n, 4]`` in canvas pixels,
    ``level [B, n]`` int32 -> ``[B, n, C, 7, 7]``."""
    from faster_rcnn_pytorch_tpu_torch.ops import roi_align as mod

    if use_kernel(rois, "MultiScaleRoIAlign"):
        return mod.multiscale_roi_align_cuda(features, rois, level)
    return mod.multiscale_roi_align_reference(features, rois, level).contiguous()


@multiscale_roi_align.register_fake
def _align_fake(features, rois, level):
    from faster_rcnn_pytorch_tpu_torch.ops.roi_align import OUTPUT_SIZE

    b, c = features[0].shape[:2]
    p = OUTPUT_SIZE
    return features[0].new_empty((b, rois.shape[1], c, p, p))


@torch.library.custom_op("frcnn::nms_segments", mutates_args=())
def nms_segments(
    boxes: Tensor, valid: Tensor, iou_threshold: float, post_k: int, tile: int
) -> tuple[Tensor, Tensor]:
    """``boxes [S, n, 4]`` (each segment sorted by descending score),
    ``valid [S, n]`` -> ``keep [S, post_k]`` int32 sorted positions (-1
    padded), ``count [S]`` int32. ``tile`` sizes the plain version's
    sweep only."""
    from faster_rcnn_pytorch_tpu_torch.ops import nms as mod

    if use_kernel(boxes, "NMS"):
        return mod.nms_segments_cuda(boxes, valid, iou_threshold, post_k)
    return mod.nms_segments_reference(boxes, valid, iou_threshold, post_k, tile)


@nms_segments.register_fake
def _nms_fake(boxes, valid, iou_threshold, post_k, tile):
    s = boxes.shape[0]
    return (
        boxes.new_empty((s, post_k), dtype=torch.int32),
        boxes.new_empty((s,), dtype=torch.int32),
    )


_lib = torch.library.Library("frcnn", "FRAGMENT")
_lib.define(
    "frozen_bn(Tensor x, Tensor mean, Tensor inv, Tensor bias, Tensor? residual, bool relu)"
    " -> Tensor"
)


def _frozen_bn(x, mean, inv, bias, residual, relu):
    """``x [B, C, H, W]``, ``mean``, ``inv``, ``bias`` ``[C]``, ``residual``
    like ``x`` or None -> ``relu?((x - mean) * inv + bias (+ residual))``."""
    from faster_rcnn_pytorch_tpu_torch.ops import frozen_bn as mod

    if use_kernel(x, "FrozenBN"):
        return mod.frozen_bn_cuda(x, mean, inv, bias, residual, relu)
    return mod.frozen_bn_reference(x, mean, inv, bias, residual, relu).contiguous()


_lib.impl("frozen_bn", _frozen_bn, "CPU")
_lib.impl("frozen_bn", _frozen_bn, "CUDA")


@torch.library.register_fake("frcnn::frozen_bn", lib=_lib)
def _frozen_bn_fake(x, mean, inv, bias, residual, relu):
    return torch.empty_like(x, memory_format=torch.contiguous_format)

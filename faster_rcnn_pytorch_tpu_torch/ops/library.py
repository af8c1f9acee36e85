"""The forward kernels that ``predict`` runs, as ``torch.library`` ops.

The kernels are bound to Python through ``PYBIND11_MODULE``
(``ops/cuda/binding.cpp``), which ``torch.export`` cannot trace. Each op
below is opaque to the tracer instead: its fake (meta) implementation gives
only the output shapes, and an exported program calls the op by name
(``torch.ops.frcnn.*``), which runs the Python implementations registered
here (each returns a contiguous tensor, as the fakes describe). Their
CUDA implementation is the kernel's wrapper, which counts its
launches (``roi_pool_cuda.launches`` and the others) whether the caller is
eager code or an exported program; their CPU implementation is the plain
version. ``plain`` (tests and ``chip_smoke.py`` only) runs the plain
version on the card too.

* ``frcnn::roi_pool``: RoIPool forward without the argmax
  (``ops/roi_pool.py``);
* ``frcnn::multiscale_roi_align``: MultiScaleRoIAlign forward over P2..P5
  (``ops/roi_align.py``);
* ``frcnn::nms_segments``: segmented exact greedy NMS (``ops/nms.py``);
* ``frcnn::frozen_bn``: FrozenBatchNorm2d with its residual add and ReLU
  (``ops/frozen_bn.py``), 53 calls a ResNet50 forward. It is defined
  through ``torch.library.Library``, whose Python kernels cost under half
  of ``custom_op``'s host time a call, and has no ``plain`` argument: its
  plain version is called by name where a caller wants it on a card.

Import this module before ``torch.export.load`` reads an artifact that
calls them (``serving.load_artifact`` does). The implementations import
their modules when called, so the kernel modules may import this one.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _no_kernel(what: str, device) -> NotImplementedError:
    return NotImplementedError(f"no {what} kernel for {device}")


@torch.library.custom_op("frcnn::roi_pool", mutates_args=())
def roi_pool(
    features: Tensor, rois: Tensor, spatial_scale: float, output_size: int, plain: bool
) -> Tensor:
    """``features [B, C, h, w]``, ``rois [B, n, 4]`` -> ``[B, n, C, P, P]``."""
    raise _no_kernel("RoIPool", features.device)


@roi_pool.register_kernel("cpu")
def _roi_pool_cpu(features, rois, spatial_scale, output_size, plain):
    from faster_rcnn_pytorch_tpu_torch.ops.roi_pool import roi_pool_reference

    return roi_pool_reference(features, rois, spatial_scale, output_size).contiguous()


@roi_pool.register_kernel("cuda")
def _roi_pool_cuda(features, rois, spatial_scale, output_size, plain):
    from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as mod

    if plain:
        return mod.roi_pool_reference(features, rois, spatial_scale, output_size).contiguous()
    return mod.roi_pool_cuda(features, rois, spatial_scale, output_size)


@roi_pool.register_fake
def _roi_pool_fake(features, rois, spatial_scale, output_size, plain):
    b, c = features.shape[:2]
    return features.new_empty((b, rois.shape[1], c, output_size, output_size))


@torch.library.custom_op("frcnn::multiscale_roi_align", mutates_args=())
def multiscale_roi_align(features: list[Tensor], rois: Tensor, level: Tensor, plain: bool) -> Tensor:
    """P2..P5 ``[B, C, h_l, w_l]``, ``rois [B, n, 4]`` in canvas pixels,
    ``level [B, n]`` int32 -> ``[B, n, C, 7, 7]``."""
    raise _no_kernel("MultiScaleRoIAlign", rois.device)


@multiscale_roi_align.register_kernel("cpu")
def _align_cpu(features, rois, level, plain):
    from faster_rcnn_pytorch_tpu_torch.ops.roi_align import multiscale_roi_align_reference

    return multiscale_roi_align_reference(features, rois, level).contiguous()


@multiscale_roi_align.register_kernel("cuda")
def _align_cuda(features, rois, level, plain):
    from faster_rcnn_pytorch_tpu_torch.ops import roi_align as mod

    if plain:
        return mod.multiscale_roi_align_reference(features, rois, level).contiguous()
    return mod.multiscale_roi_align_cuda(features, rois, level)


@multiscale_roi_align.register_fake
def _align_fake(features, rois, level, plain):
    from faster_rcnn_pytorch_tpu_torch.ops.roi_align import OUTPUT_SIZE

    b, c = features[0].shape[:2]
    p = OUTPUT_SIZE
    return features[0].new_empty((b, rois.shape[1], c, p, p))


@torch.library.custom_op("frcnn::nms_segments", mutates_args=())
def nms_segments(
    boxes: Tensor, valid: Tensor, iou_threshold: float, post_k: int, tile: int, plain: bool
) -> tuple[Tensor, Tensor]:
    """``boxes [S, n, 4]`` (each segment sorted by descending score),
    ``valid [S, n]`` -> ``keep [S, post_k]`` int32 sorted positions (-1
    padded), ``count [S]`` int32. ``tile`` sizes the plain version's
    sweep only."""
    raise _no_kernel("NMS", boxes.device)


@nms_segments.register_kernel("cpu")
def _nms_cpu(boxes, valid, iou_threshold, post_k, tile, plain):
    from faster_rcnn_pytorch_tpu_torch.ops.nms import nms_segments_reference

    return nms_segments_reference(boxes, valid, iou_threshold, post_k, tile)


@nms_segments.register_kernel("cuda")
def _nms_cuda(boxes, valid, iou_threshold, post_k, tile, plain):
    from faster_rcnn_pytorch_tpu_torch.ops import nms as mod

    if plain:
        return mod.nms_segments_reference(boxes, valid, iou_threshold, post_k, tile)
    return mod.nms_segments_cuda(boxes, valid, iou_threshold, post_k)


@nms_segments.register_fake
def _nms_fake(boxes, valid, iou_threshold, post_k, tile, plain):
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


def _frozen_bn_cpu(x, mean, inv, bias, residual, relu):
    """``x [B, C, H, W]``, ``mean``, ``inv``, ``bias`` ``[C]``, ``residual``
    like ``x`` or None -> ``relu?((x - mean) * inv + bias (+ residual))``."""
    from faster_rcnn_pytorch_tpu_torch.ops.frozen_bn import frozen_bn_reference

    return frozen_bn_reference(x, mean, inv, bias, residual, relu).contiguous()


def _frozen_bn_cuda(x, mean, inv, bias, residual, relu):
    from faster_rcnn_pytorch_tpu_torch.ops.frozen_bn import frozen_bn_cuda

    return frozen_bn_cuda(x, mean, inv, bias, residual, relu)


_lib.impl("frozen_bn", _frozen_bn_cpu, "CPU")
_lib.impl("frozen_bn", _frozen_bn_cuda, "CUDA")


@torch.library.register_fake("frcnn::frozen_bn", lib=_lib)
def _frozen_bn_fake(x, mean, inv, bias, residual, relu):
    return torch.empty_like(x, memory_format=torch.contiguous_format)

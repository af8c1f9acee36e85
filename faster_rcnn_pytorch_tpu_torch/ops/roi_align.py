"""MultiScaleRoIAlign (7x7, sampling ratio 2, ``aligned=False``) over the
FPN levels P2..P5, NCHW.

Counterpart of the forward of ``faster_rcnn_pytorch_tpu/ops/roi_align.py``
(``fpn_level_assignment``, ``_sample_coords``, ``_corner_starts_weights``,
``multiscale_roi_align_batch``). Semantics, as torchvision's
``roi_align(aligned=False)``:

* each roi goes to one level, ``floor(4 + log2(sqrt(area) / 224 + 1e-6))``
  clamped to [2, 5] (the eps inside the log, as the JAX package has it);
* at that level's scale ``s = 1 / stride``: start ``x1 * s``, extent
  ``max(x2 * s - x1 * s, 1)``, bin ``extent / 7``, and two samples per bin
  axis at ``start + bin * bin_size + (sub + 0.5) * bin_size / 2``;
* a sample outside ``[-1, size]`` adds zero; a coordinate clamps at 0; a
  low cell ``>= size - 1`` collapses onto the last cell with weight 1;
* the output is the mean of the bin's 2x2 bilinear samples, computed in
  float32 and cast to the features' dtype.

:func:`multiscale_roi_align_batch` dispatches: a CUDA tensor goes to the
hand-written kernel (``ops/cuda/roi_align.cu``), a CPU tensor to the plain
version :func:`multiscale_roi_align_reference`, which adds the samples in
the kernel's order so the two agree bit for bit. The TPU package's window
kernel, its ``fits`` mask and its corner-gather fallback are a VMEM layout
and are not ported: every roi here is exact whatever its size.
"""

from __future__ import annotations

import torch

STRIDES = (4, 8, 16, 32)
OUTPUT_SIZE = 7
SAMPLING_RATIO = 2

# Rois gathered per step by the plain version (bounds its transient
# memory: 64 rois x 256 channels x 196 samples x 4 bytes per corner).
_ROI_CHUNK = 64


def fpn_level_assignment(rois: torch.Tensor) -> torch.Tensor:
    """``rois [..., 4]`` canvas pixels -> 0-based int32 level per roi:
    ``floor(4 + log2(sqrt(area) / 224 + 1e-6))`` clamped to [2, 5], minus 2."""
    rois = rois.float()
    area = (rois[..., 2] - rois[..., 0]).clamp(min=0) * (rois[..., 3] - rois[..., 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-6))
    return (lvl.clamp(2, 5) - 2).to(torch.int32)


def _axis_samples(lo_edge, hi_edge, scale: float, size: int):
    """Per-axis geometry of ``r`` rois at one level: ``[r, P, ratio]``
    int64 low/high cells and float32 low/high weights (zero outside
    ``[-1, size]``)."""
    start = lo_edge * scale
    extent = torch.clamp(hi_edge * scale - start, min=1.0)
    # A true division: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which the kernel (and XLA) do not.
    bin_size = extent / torch.full_like(extent, OUTPUT_SIZE)
    dev = lo_edge.device
    p = torch.arange(OUTPUT_SIZE, dtype=torch.float32, device=dev)
    sub = torch.arange(SAMPLING_RATIO, dtype=torch.float32, device=dev)
    b = bin_size[:, None, None]
    offsets = p[None, :, None] * b + (sub[None, None, :] + 0.5) * b / SAMPLING_RATIO
    coords = start[:, None, None] + offsets
    valid = (coords >= -1.0) & (coords <= size)
    c = coords.clamp(min=0.0)
    low = torch.floor(c).to(torch.int64)
    collapse = low >= size - 1
    low = torch.where(collapse, size - 1, low)
    high = torch.where(collapse, low, low + 1)
    c = torch.where(collapse, low.float(), c)
    frac = c - low.float()
    zero = torch.zeros((), device=dev)
    w_low = torch.where(valid, 1.0 - frac, zero)
    w_high = torch.where(valid, frac, zero)
    return low, high, w_low, w_high


def multiscale_roi_align_reference(features, rois: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch MultiScaleRoIAlign, the twin of the CUDA kernel.

    Args:
      features: P2..P5 ``[B, C, h_l, w_l]`` float32 or bfloat16 maps at
        ``STRIDES``.
      rois: ``[B, n, 4]`` float32 xyxy in canvas pixels.
      level: ``[B, n]`` int32 from :func:`fpn_level_assignment`.

    Returns ``[B, n, C, 7, 7]`` in the features' dtype. Per sample the four
    corners add as ``w_ll*v_ll + w_lh*v_lh + w_hl*v_hl + w_hh*v_hh`` with
    ``w = wy * wx``; the samples add in (y, x) order (0,0), (0,1), (1,0),
    (1,1), and the sum is divided by 4 - the kernel's order, one rounding
    per operation.
    """
    b, n = rois.shape[:2]
    c = features[0].shape[1]
    p = OUTPUT_SIZE
    dev = rois.device
    flat_rois = rois.reshape(b * n, 4).float()
    flat_level = level.reshape(b * n)
    image = torch.arange(b, device=dev).repeat_interleave(n)
    out = torch.zeros((b * n, c, p, p), dtype=torch.float32, device=dev)
    for li, (feat, stride) in enumerate(zip(features, STRIDES)):
        h, w = feat.shape[-2:]
        nhwc = feat.float().permute(0, 2, 3, 1)  # [B, h, w, C]
        idx = torch.nonzero(flat_level == li).flatten()
        for s in range(0, idx.numel(), _ROI_CHUNK):
            sel = idx[s : s + _ROI_CHUNK]
            r = flat_rois[sel]
            scale = 1.0 / stride
            ylo, yhi, wylo, wyhi = _axis_samples(r[:, 1], r[:, 3], scale, h)
            xlo, xhi, wxlo, wxhi = _axis_samples(r[:, 0], r[:, 2], scale, w)
            im = image[sel][:, None, None, None, None]

            def gather(ys, xs):  # -> [r, P(y), ratio, P(x), ratio, C]
                return nhwc[im, ys[:, :, :, None, None], xs[:, None, None, :, :]]

            def weight(wy, wx):
                return (wy[:, :, :, None, None] * wx[:, None, None, :, :])[..., None]

            val = weight(wylo, wxlo) * gather(ylo, xlo)
            val = val + weight(wylo, wxhi) * gather(ylo, xhi)
            val = val + weight(wyhi, wxlo) * gather(yhi, xlo)
            val = val + weight(wyhi, wxhi) * gather(yhi, xhi)
            acc = val[:, :, 0, :, 0] + val[:, :, 0, :, 1]
            acc = acc + val[:, :, 1, :, 0]
            acc = acc + val[:, :, 1, :, 1]
            out[sel] = (acc / (SAMPLING_RATIO * SAMPLING_RATIO)).permute(0, 3, 1, 2)
    return out.reshape(b, n, c, p, p).to(features[0].dtype)


def multiscale_roi_align_cuda(features, rois: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel (``ops/cuda/roi_align.cu``), same
    arguments and result as :func:`multiscale_roi_align_reference`.
    Counts its launches in ``multiscale_roi_align_cuda.launches``."""
    if len(features) != len(STRIDES):
        raise ValueError(f"want the four levels P2..P5, got {len(features)}")
    dtype = features[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, not {dtype}")
    b, c = features[0].shape[:2]
    for f in features:
        if not f.is_cuda or f.dim() != 4 or f.dtype != dtype or tuple(f.shape[:2]) != (b, c):
            raise ValueError(f"want CUDA levels [B, C, h, w] of one dtype, got {tuple(f.shape)}")
    if not (rois.is_cuda and level.is_cuda):
        raise ValueError("multiscale_roi_align_cuda needs CUDA tensors")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"want float32 rois [B, n, 4], got {tuple(rois.shape)} {rois.dtype}")
    if level.dtype != torch.int32 or level.shape != rois.shape[:2]:
        raise ValueError(f"want an int32 level [B, n], got {tuple(level.shape)} {level.dtype}")
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    n = rois.shape[1]
    p = OUTPUT_SIZE
    out = torch.empty((b, n, c, p, p), dtype=dtype, device=rois.device)
    ext.roi_align_forward(
        [f.contiguous() for f in features], rois.contiguous(), level.contiguous(), out
    )
    multiscale_roi_align_cuda.launches += 1
    return out


multiscale_roi_align_cuda.launches = 0


def multiscale_roi_align_batch(features, rois: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """``features`` P2..P5 ``[B, C, h_l, w_l]`` at ``STRIDES``, ``rois
    [B, n, 4]`` in canvas pixels -> ``[B, n, C, 7, 7]`` in the features'
    dtype.

    A CUDA tensor runs the hand kernel, a CPU tensor the plain version.
    ``plain=True`` is for tests only: it runs the plain version on any
    device, so a caller can hold the kernel's path against it.
    """
    rois = rois.float()
    level = fpn_level_assignment(rois)
    if rois.is_cuda and not plain:
        return multiscale_roi_align_cuda(features, rois, level)
    if rois.device.type != "cpu" and not plain:
        raise NotImplementedError(f"no MultiScaleRoIAlign kernel for {rois.device}")
    return multiscale_roi_align_reference(features, rois, level)

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

The features-gradient is the exact adjoint for every roi: each bin's
upstream gradient times ``0.25 * wy * wx`` added at each of its 16
corners, summed in float32 and cast once to the features' dtype (the JAX
package's ``_msra_batch_bwd``). Rois get no gradient.

:func:`multiscale_roi_align_batch` goes through an autograd function
when the features need a gradient (through the ``frcnn::multiscale_roi_align``
op otherwise): a CUDA tensor runs the hand-written kernels
(``ops/cuda/roi_align.cu``, forward and backward), a CPU tensor the plain
versions (``ops/library.py::use_kernel``)
:func:`multiscale_roi_align_reference` (which adds the samples in the
kernel's order, so the two agree bit for bit) and
:func:`multiscale_roi_align_backward_reference`. The TPU package's window
kernels, their ``fits`` mask, the backward's read-modify-write DMA
protocol and the corner-gather and dense-VJP fallbacks are a VMEM layout
and are not ported: every roi here is exact whatever its size.

:func:`multiscale_roi_align_slots` is the same function in the order of
operations of the JAX package's round-1 slot-lattice kernel
(``ops/pallas/roi_align_kernel.py``: ``_corner_starts_weights``' two-cell
windows, weights divided by the ratio, x then y), with its own kernel
(``ops/cuda/roi_align_slots.cu``) and plain version, forward only. As in
the JAX package, no model calls it.
"""

from __future__ import annotations

import torch

from faster_rcnn_pytorch_tpu_torch.ops.library import use_kernel  # also registers frcnn::*

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


def _check_cuda_forward_args(features, rois: torch.Tensor, level: torch.Tensor) -> None:
    """Raise on what the forward kernels do not take."""
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
        raise ValueError("the MultiScaleRoIAlign kernels need CUDA tensors")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"want float32 rois [B, n, 4], got {tuple(rois.shape)} {rois.dtype}")
    if level.dtype != torch.int32 or level.shape != rois.shape[:2]:
        raise ValueError(f"want an int32 level [B, n], got {tuple(level.shape)} {level.dtype}")


def multiscale_roi_align_cuda(features, rois: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel (``ops/cuda/roi_align.cu``), same
    arguments and result as :func:`multiscale_roi_align_reference`.
    Counts its launches in ``multiscale_roi_align_cuda.launches``."""
    _check_cuda_forward_args(features, rois, level)
    b, c = features[0].shape[:2]
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    n = rois.shape[1]
    p = OUTPUT_SIZE
    out = torch.empty((b, n, c, p, p), dtype=features[0].dtype, device=rois.device)
    ext.roi_align_forward(
        [f.contiguous() for f in features], rois.contiguous(), level.contiguous(), out
    )
    multiscale_roi_align_cuda.launches += 1
    return out


multiscale_roi_align_cuda.launches = 0


def _corner_windows(lo_edge, hi_edge, scale: float, size: int):
    """Per-axis two-cell windows of ``r`` rois at one level, the JAX
    package's ``_corner_starts_weights`` with the sampling ratio folded in:
    ``[r, P, ratio]`` int64 window starts and the float32 weights of the
    window's two cells, each divided by the ratio. A sample outside ``[-1,
    size]`` has zero weights; a low cell ``>= size - 1`` collapses: the
    window starts at ``size - 2`` with the weight in its second cell
    (``size >= 2``)."""
    low, high, w_low, w_high = _axis_samples(lo_edge, hi_edge, scale, size)
    collapse = low == high  # then w_high is 0 and w_low carries the weight
    start = torch.where(collapse, low - 1, low)
    zero = torch.zeros((), device=lo_edge.device)
    ratio = torch.full_like(w_low, SAMPLING_RATIO)
    w0 = torch.where(collapse, zero, w_low) / ratio
    w1 = torch.where(collapse, w_low, w_high) / ratio
    return start, w0, w1


def multiscale_roi_align_slots_reference(
    features, rois: torch.Tensor, level: torch.Tensor
) -> torch.Tensor:
    """Plain-PyTorch MultiScaleRoIAlign in the order of operations of the
    JAX package's slot-lattice kernel (``ops/pallas/roi_align_kernel.py``),
    the twin of ``ops/cuda/roi_align_slots.cu``.

    Same arguments and result as :func:`multiscale_roi_align_reference`
    (the same function, other rounding), with every level map at least
    2x2. Per sample, x first: ``t(y) = wx0 * v[y, x0] + wx1 * v[y, x0 +
    1]`` for the window's two rows, then ``wy0 * t(y0) + wy1 * t(y0 + 1)``,
    the weights already divided by the ratio (:func:`_corner_windows`); a
    bin's samples add in (y, x) order (0,0), (0,1), (1,0), (1,1), with no
    final division.
    """
    for f in features:
        if f.shape[-2] < 2 or f.shape[-1] < 2:
            raise ValueError(f"every level map must be at least 2x2, got {tuple(f.shape)}")
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
            y0, wy0, wy1 = _corner_windows(r[:, 1], r[:, 3], 1.0 / stride, h)
            x0, wx0, wx1 = _corner_windows(r[:, 0], r[:, 2], 1.0 / stride, w)
            im = image[sel][:, None, None, None, None]
            xs = x0[:, None, None, :, :]
            wx0_, wx1_ = (t[:, None, None, :, :, None] for t in (wx0, wx1))

            def row(ys):  # x-interpolation on rows ys -> [r, P(y), ratio, P(x), ratio, C]
                ys = ys[:, :, :, None, None]
                return wx0_ * nhwc[im, ys, xs] + wx1_ * nhwc[im, ys, xs + 1]

            val = wy0[:, :, :, None, None, None] * row(y0) + wy1[:, :, :, None, None, None] * row(y0 + 1)
            acc = val[:, :, 0, :, 0] + val[:, :, 0, :, 1]
            acc = acc + val[:, :, 1, :, 0]
            acc = acc + val[:, :, 1, :, 1]
            out[sel] = acc.permute(0, 3, 1, 2)
    return out.reshape(b, n, c, p, p).to(features[0].dtype)


def multiscale_roi_align_slots_cuda(features, rois: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The hand-written Hopper kernel of the slot-lattice order
    (``ops/cuda/roi_align_slots.cu``), same arguments and result as
    :func:`multiscale_roi_align_slots_reference`. Counts its launches in
    ``multiscale_roi_align_slots_cuda.launches``."""
    _check_cuda_forward_args(features, rois, level)
    for f in features:
        if f.shape[-2] < 2 or f.shape[-1] < 2:
            raise ValueError(f"every level map must be at least 2x2, got {tuple(f.shape)}")
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    b, c = features[0].shape[:2]
    n = rois.shape[1]
    p = OUTPUT_SIZE
    out = torch.empty((b, n, c, p, p), dtype=features[0].dtype, device=rois.device)
    ext.roi_align_slots_forward(
        [f.contiguous() for f in features], rois.contiguous(), level.contiguous(), out
    )
    multiscale_roi_align_slots_cuda.launches += 1
    return out


multiscale_roi_align_slots_cuda.launches = 0


def multiscale_roi_align_slots(features, rois: torch.Tensor) -> torch.Tensor:
    """The slot-lattice MultiScaleRoIAlign, forward only: ``features``
    P2..P5 ``[B, C, h_l, w_l]`` (each at least 2x2), ``rois [B, n, 4]`` in
    canvas pixels -> ``[B, n, C, 7, 7]`` in the features' dtype.

    A CUDA tensor runs its hand kernel, a CPU tensor the plain version
    (``ops/library.py::use_kernel``). No model calls it: the FPN head uses
    :func:`multiscale_roi_align_batch`, as the JAX package's head uses its
    window kernel and keeps the slot-lattice kernel for the record.
    """
    rois = rois.float()
    level = fpn_level_assignment(rois)
    if use_kernel(rois, "slot-lattice RoIAlign"):
        return multiscale_roi_align_slots_cuda(features, rois, level)
    return multiscale_roi_align_slots_reference(features, rois, level)


def backward_scatter_terms(grad, rois, image, stride: int, h: int, w: int):
    """The adjoint's terms for ``k`` rois at one level: ``grad [k, C, 7,
    7]`` float32, ``rois [k, 4]`` and their ``image`` indices -> ``rows
    [k * 784]`` int64 into the level's ``[B * h * w]`` cells (NHWC order)
    and ``vals [k * 784, C]`` float32, one per (bin, sample, corner):
    ``(g * 0.25) * (wy * wx)``, the kernel's products in its order (the
    kernel then sums each cell's terms of one roi before it adds them to
    the map; here every term is added on its own). A weight outside
    ``[-1, size]`` is zero; its row stays inside the map."""
    k, c = grad.shape[:2]
    ylo, yhi, wylo, wyhi = _axis_samples(rois[:, 1], rois[:, 3], 1.0 / stride, h)
    xlo, xhi, wxlo, wxhi = _axis_samples(rois[:, 0], rois[:, 2], 1.0 / stride, w)
    ys, wy = torch.stack([ylo, yhi], -1), torch.stack([wylo, wyhi], -1)  # [k, P, ratio, 2]
    xs, wx = torch.stack([xlo, xhi], -1), torch.stack([wxlo, wxhi], -1)
    # -> [k, P(y), ratio, 2, P(x), ratio, 2]
    rows = (image[:, None, None, None, None, None, None] * h + ys[..., None, None, None]) * w
    rows = rows + xs[:, None, None, None]
    weight = wy[..., None, None, None] * wx[:, None, None, None]
    gq = (grad.permute(0, 2, 3, 1) * 0.25)[:, :, None, None, :, None, None, :]  # [k, P, 1, 1, P, 1, 1, C]
    vals = gq * weight[..., None]
    return rows.reshape(-1), vals.reshape(-1, c)


def multiscale_roi_align_backward_reference(
    grad: torch.Tensor, rois: torch.Tensor, level: torch.Tensor, level_shapes, dtype: torch.dtype
) -> list[torch.Tensor]:
    """Plain-PyTorch features-gradient of MultiScaleRoIAlign, the twin of
    the CUDA backward kernel.

    Args:
      grad: ``[B, n, C, 7, 7]`` float32 or bfloat16 upstream gradient.
      rois: ``[B, n, 4]`` float32 canvas pixels; level: ``[B, n]`` int32
        from :func:`fpn_level_assignment`.
      level_shapes: ``(h, w)`` of P2..P5.
      dtype: the features' dtype.

    Returns P2..P5 ``[B, C, h_l, w_l]`` in ``dtype``: every term of
    :func:`backward_scatter_terms` added (``scatter_add_``, in a fixed
    order on the CPU) into a float32 map, then cast once, as the JAX
    package's ``(a + b.astype(f32)).astype(f.dtype)``. Its sums run in
    another order than the kernel's atomics: the two agree bit for bit
    only where every order gives the same float32 sum.
    """
    b, n, c = grad.shape[:3]
    dev = grad.device
    flat_g = grad.reshape(b * n, c, OUTPUT_SIZE, OUTPUT_SIZE).float()
    flat_rois = rois.reshape(b * n, 4).float()
    flat_level = level.reshape(b * n)
    image = torch.arange(b, device=dev).repeat_interleave(n)
    maps = []
    for li, ((h, w), stride) in enumerate(zip(level_shapes, STRIDES)):
        acc = torch.zeros((b * h * w, c), dtype=torch.float32, device=dev)
        idx = torch.nonzero(flat_level == li).flatten()
        for s in range(0, idx.numel(), _ROI_CHUNK):
            sel = idx[s : s + _ROI_CHUNK]
            rows, vals = backward_scatter_terms(flat_g[sel], flat_rois[sel], image[sel], stride, h, w)
            acc.scatter_add_(0, rows[:, None].expand(-1, c), vals)
        maps.append(acc.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous().to(dtype))
    return maps


def multiscale_roi_align_backward_cuda(
    grad: torch.Tensor, rois: torch.Tensor, level: torch.Tensor, level_shapes, dtype: torch.dtype
) -> list[torch.Tensor]:
    """The hand-written Hopper backward (``ops/cuda/roi_align.cu``), same
    arguments and result as :func:`multiscale_roi_align_backward_reference`:
    atomic float32 adds into zeroed ``[B, C, h, w]`` maps, cast to
    ``dtype``. Counts its launches in
    ``multiscale_roi_align_backward_cuda.launches``."""
    if not (grad.is_cuda and rois.is_cuda and level.is_cuda):
        raise ValueError("multiscale_roi_align_backward_cuda needs CUDA tensors")
    if grad.dtype not in (torch.float32, torch.bfloat16) or dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grad and features must be float32 or bfloat16, not {grad.dtype}, {dtype}")
    p = OUTPUT_SIZE
    if grad.dim() != 5 or tuple(grad.shape[3:]) != (p, p):
        raise ValueError(f"want grad [B, n, C, {p}, {p}], got {tuple(grad.shape)}")
    b, n, c = grad.shape[:3]
    if rois.dtype != torch.float32 or tuple(rois.shape) != (b, n, 4):
        raise ValueError(f"want float32 rois [{b}, {n}, 4], got {tuple(rois.shape)} {rois.dtype}")
    if level.dtype != torch.int32 or tuple(level.shape) != (b, n):
        raise ValueError(f"want an int32 level [{b}, {n}], got {tuple(level.shape)} {level.dtype}")
    if len(level_shapes) != len(STRIDES):
        raise ValueError(f"want the four levels P2..P5, got {len(level_shapes)}")
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    maps = [torch.zeros((b, c, h, w), dtype=torch.float32, device=grad.device) for h, w in level_shapes]
    ext.roi_align_backward(grad.contiguous(), rois.contiguous(), level.contiguous(), maps)
    multiscale_roi_align_backward_cuda.launches += 1
    return [m.to(dtype) for m in maps]


multiscale_roi_align_backward_cuda.launches = 0


def multiscale_roi_align_backward(grad, rois, level, level_shapes, dtype):
    """Features-gradient dispatch (``ops/library.py::use_kernel``): the
    hand kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if use_kernel(grad, "MultiScaleRoIAlign backward"):
        return multiscale_roi_align_backward_cuda(grad, rois, level, level_shapes, dtype)
    return multiscale_roi_align_backward_reference(grad, rois, level, level_shapes, dtype)


class _MultiScaleRoIAlign(torch.autograd.Function):
    """MultiScaleRoIAlign with its features-gradient (the JAX package's
    custom VJP). The forward keeps the rois, the level and the level
    shapes for the backward, not the maps, and the backward takes the
    forward's path; rois get no gradient (proposals and sampled rois are
    constants of the train step)."""

    @staticmethod
    def forward(ctx, rois, level, *features):
        ctx.save_for_backward(rois, level)
        ctx.level_shapes = [tuple(f.shape[-2:]) for f in features]
        ctx.features_dtype = features[0].dtype
        ctx.kernel = use_kernel(rois, "MultiScaleRoIAlign")
        forward = multiscale_roi_align_cuda if ctx.kernel else multiscale_roi_align_reference
        return forward(features, rois, level)

    @staticmethod
    def backward(ctx, grad):
        rois, level = ctx.saved_tensors
        backward = (
            multiscale_roi_align_backward_cuda if ctx.kernel else multiscale_roi_align_backward_reference
        )
        dfeats = backward(grad, rois, level, ctx.level_shapes, ctx.features_dtype)
        return (None, None, *dfeats)


def multiscale_roi_align_batch(features, rois: torch.Tensor) -> torch.Tensor:
    """``features`` P2..P5 ``[B, C, h_l, w_l]`` at ``STRIDES``, ``rois
    [B, n, 4]`` in canvas pixels -> ``[B, n, C, 7, 7]`` in the features'
    dtype, differentiable in the features.

    A CUDA tensor runs the hand kernels (forward, and backward when the
    features need a gradient), a CPU tensor the plain versions. Without a
    gradient (predict) the forward is the ``frcnn::multiscale_roi_align``
    op (``ops/library.py``), which an exported program calls too.
    """
    rois = rois.float()
    level = fpn_level_assignment(rois)
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return _MultiScaleRoIAlign.apply(rois, level, *features)
    return torch.ops.frcnn.multiscale_roi_align(list(features), rois, level)

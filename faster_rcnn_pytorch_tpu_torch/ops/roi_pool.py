"""RoIPool (7x7 max pooling with integer bins) over NCHW features.

Counterpart of ``faster_rcnn_pytorch_tpu/ops/roi_pool.py``. Semantics are
the JAX package's, bit for bit:

* roi corners are rounded to cells with round-half-to-even
  (``jnp.round``; torchvision would round half away from zero),
* ``extent = max(end - start + 1, 1)``,
* bin ``p`` covers ``[start + (p*e)//P, start + ((p+1)*e + P-1)//P)``,
  computed in integers (float division is a known off-by-one trap) and
  clipped to the map,
* value = max over the bin (compared in float32), 0 for an empty bin,
* optional int32 argmax: the first max in row-major order as
  ``row * width + col``, -1 for an empty bin. (The TPU kernel flattens as
  ``row * w_pad + col`` with ``w_pad`` rounded up to 8, a layout artifact
  the port does not carry.)

:func:`roi_pool_batch` dispatches: a CUDA tensor goes to the hand-written
kernels (``ops/cuda/roi_pool.cu``) and a CPU tensor to the plain versions,
:func:`roi_pool_reference` and :func:`roi_pool_backward_reference`. The
gradient w.r.t. the features adds each pooled cell's upstream gradient at
its argmax cell (ties went to the first max in the forward, as in the
TPU kernel; ``jax.grad`` of a plain max would split them). There is no
fallback: a build or launch failure on a CUDA tensor raises.
"""

from __future__ import annotations

import torch

# Rois gathered per step by the plain version (bounds its transient memory).
_ROI_CHUNK = 32


def _bin_bounds(start, extent, size: int, output_size: int):
    """Integer ``[lo, hi)`` bounds ``[R, P]`` per bin, clipped to
    ``[0, size]``."""
    p = torch.arange(output_size, dtype=torch.int64, device=start.device)
    e = extent[:, None]
    lo = (p[None, :] * e) // output_size
    hi = ((p[None, :] + 1) * e + output_size - 1) // output_size
    lo = (lo + start[:, None]).clamp(0, size)
    hi = (hi + start[:, None]).clamp(0, size)
    return lo, hi


def roi_bin_bounds(rois, spatial_scale: float, output_size: int, h: int, w: int):
    """``rois [R, 4]`` xyxy -> ``(h_lo, h_hi, w_lo, w_hi)``, each ``[R, P]``
    int64 (``_compute_bounds`` of the TPU kernel)."""
    corners = torch.round(rois.float() * spatial_scale).to(torch.int64)
    sx, sy, ex, ey = corners.unbind(-1)
    ext_w = (ex - sx + 1).clamp(min=1)
    ext_h = (ey - sy + 1).clamp(min=1)
    h_lo, h_hi = _bin_bounds(sy, ext_h, h, output_size)
    w_lo, w_hi = _bin_bounds(sx, ext_w, w, output_size)
    return h_lo, h_hi, w_lo, w_hi


def roi_pool_reference(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float = 1.0,
    output_size: int = 7,
    with_argmax: bool = False,
):
    """Plain-PyTorch RoIPool, the twin of ``roi_pool_lax``.

    Args:
      features: ``[B, C, h, w]`` float32 or bfloat16 (compared in float32).
      rois: ``[B, n, 4]`` xyxy, scaled by ``spatial_scale`` into cells.

    Returns ``[B, n, C, P, P]`` in the features' dtype, plus the int32
    argmax of the same shape when ``with_argmax``.

    Every bin is evaluated over a window as large as the largest bin of
    the call, so rois of any extent, inside the map or not, are exact.
    """
    b, c, h, w = features.shape
    n = rois.shape[1]
    p = output_size
    dev = features.device
    flat = rois.reshape(b * n, 4)
    h_lo, h_hi, w_lo, w_hi = roi_bin_bounds(flat, spatial_scale, p, h, w)
    k_h = max(int((h_hi - h_lo).max()), 1) if n else 1
    k_w = max(int((w_hi - w_lo).max()), 1) if n else 1

    rows = h_lo[:, :, None] + torch.arange(k_h, device=dev)  # [R, P, kh]
    row_ok = rows < h_hi[:, :, None]
    rows = rows.clamp(max=h - 1)
    cols = w_lo[:, :, None] + torch.arange(k_w, device=dev)  # [R, P, kw]
    col_ok = cols < w_hi[:, :, None]
    cols = cols.clamp(max=w - 1)
    empty = (h_hi <= h_lo)[:, :, None] | (w_hi <= w_lo)[:, None, :]  # [R,P,P]
    image = torch.arange(b, device=dev).repeat_interleave(n)

    nhwc = features.float().permute(0, 2, 3, 1)  # [B, h, w, C]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    out = torch.empty((b * n, p, p, c), dtype=torch.float32, device=dev)
    arg = (
        torch.empty((b * n, p, p, c), dtype=torch.int32, device=dev)
        if with_argmax
        else None
    )
    for s in range(0, b * n, _ROI_CHUNK):
        sl = slice(s, s + _ROI_CHUNK)
        r_idx = rows[sl][:, :, None, :, None]  # [r, P, 1, kh, 1]
        c_idx = cols[sl][:, None, :, None, :]  # [r, 1, P, 1, kw]
        window = nhwc[image[sl][:, None, None, None, None], r_idx, c_idx]
        ok = row_ok[sl][:, :, None, :, None] & col_ok[sl][:, None, :, None, :]
        r = window.shape[0]
        window = torch.where(ok[..., None], window, neg_inf)
        window = window.reshape(r, p, p, k_h * k_w, c)
        vals = window.amax(dim=3)  # [r, P, P, C]
        e = empty[sl][..., None]
        out[sl] = torch.where(e, 0.0, vals)
        if with_argmax:
            pos = (r_idx * w + c_idx).expand(r, p, p, k_h, k_w)
            pos = pos.reshape(r, p, p, k_h * k_w, 1).to(torch.int32)
            hit = ok.reshape(r, p, p, k_h * k_w, 1) & (window == vals[:, :, :, None])
            first = torch.where(hit, pos, torch.iinfo(torch.int32).max).amin(dim=3)
            arg[sl] = torch.where(e, -1, first)

    out = out.permute(0, 3, 1, 2).reshape(b, n, c, p, p).to(features.dtype)
    if with_argmax:
        return out, arg.permute(0, 3, 1, 2).reshape(b, n, c, p, p)
    return out


def roi_pool_cuda(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float = 1.0,
    output_size: int = 7,
    with_argmax: bool = False,
):
    """The hand-written Hopper kernel (``ops/cuda/roi_pool.cu``), same
    arguments and results as :func:`roi_pool_reference`. Counts its
    launches in ``roi_pool_cuda.launches``."""
    if not (features.is_cuda and rois.is_cuda):
        raise ValueError("roi_pool_cuda needs CUDA tensors")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, not {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, not {rois.dtype}")
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(
            f"want features [B,C,h,w] and rois [B,n,4], got "
            f"{tuple(features.shape)} and {tuple(rois.shape)}"
        )
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    b, c = features.shape[:2]
    n = rois.shape[1]
    p = output_size
    out = torch.empty((b * n, c, p, p), dtype=features.dtype, device=features.device)
    arg = torch.empty(
        (b * n, c, p, p) if with_argmax else (0,),
        dtype=torch.int32,
        device=features.device,
    )
    ext.roi_pool_forward(
        features.contiguous(), rois.contiguous(), float(spatial_scale), p, out, arg
    )
    roi_pool_cuda.launches += 1
    out = out.reshape(b, n, c, p, p)
    if with_argmax:
        return out, arg.reshape(b, n, c, p, p)
    return out


roi_pool_cuda.launches = 0


def roi_pool_backward_reference(
    grad: torch.Tensor, argmax: torch.Tensor, features_shape, dtype: torch.dtype
) -> torch.Tensor:
    """Plain-PyTorch features-gradient of RoIPool, the twin of the CUDA
    backward kernel: each pooled cell's upstream gradient is added at its
    argmax cell, summed over rois, in float32, then cast to ``dtype``.

    Args:
      grad: ``[B, n, C, P, P]`` float32 or bfloat16 upstream gradient.
      argmax: ``[B, n, C, P, P]`` int32 from the forward (``row * w +
        col``, -1 for an empty bin, which contributes nothing).
      features_shape: ``(B, C, h, w)``.
    """
    b, c, h, w = features_shape
    flat_g = grad.float().transpose(1, 2).reshape(b, c, -1)
    flat_a = argmax.transpose(1, 2).reshape(b, c, -1).long()
    # Empty bins go to a dump cell past the map, dropped below.
    flat_a = torch.where(flat_a >= 0, flat_a, h * w)
    dfeat = torch.zeros((b, c, h * w + 1), dtype=torch.float32, device=grad.device)
    dfeat.scatter_add_(2, flat_a, flat_g)
    return dfeat[:, :, : h * w].reshape(b, c, h, w).to(dtype)


def roi_pool_backward_cuda(
    grad: torch.Tensor, argmax: torch.Tensor, features_shape, dtype: torch.dtype
) -> torch.Tensor:
    """The hand-written Hopper backward (``ops/cuda/roi_pool.cu``), same
    arguments and result as :func:`roi_pool_backward_reference`: atomic
    float32 adds into a zeroed ``[B, C, h, w]`` scratch, cast to
    ``dtype``. Counts its launches in ``roi_pool_backward_cuda.launches``."""
    if not (grad.is_cuda and argmax.is_cuda):
        raise ValueError("roi_pool_backward_cuda needs CUDA tensors")
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grad must be float32 or bfloat16, not {grad.dtype}")
    if argmax.dtype != torch.int32 or argmax.shape != grad.shape or grad.dim() != 5:
        raise ValueError(
            f"want grad [B,n,C,P,P] and an int32 argmax of its shape, got "
            f"{tuple(grad.shape)} and {tuple(argmax.shape)} {argmax.dtype}"
        )
    b, c, h, w = features_shape
    if grad.shape[0] != b or grad.shape[2] != c:
        raise ValueError(f"grad {tuple(grad.shape)} does not match features {features_shape}")
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    dfeat = torch.zeros((b, c, h, w), dtype=torch.float32, device=grad.device)
    ext.roi_pool_backward(grad.contiguous(), argmax.contiguous(), dfeat)
    roi_pool_backward_cuda.launches += 1
    return dfeat.to(dtype)


roi_pool_backward_cuda.launches = 0


def roi_pool_backward(grad, argmax, features_shape, dtype, plain: bool = False):
    """Features-gradient dispatch: a CUDA tensor runs the hand kernel, a
    CPU tensor (or the test-only ``plain``) the plain version."""
    if grad.is_cuda and not plain:
        return roi_pool_backward_cuda(grad, argmax, features_shape, dtype)
    if grad.device.type != "cpu" and not plain:
        raise NotImplementedError(f"no RoIPool backward kernel for {grad.device}")
    return roi_pool_backward_reference(grad, argmax, features_shape, dtype)


def _roi_pool_forward(features, rois, spatial_scale, output_size, with_argmax, plain):
    if features.is_cuda and not plain:
        return roi_pool_cuda(features, rois, spatial_scale, output_size, with_argmax)
    if features.device.type != "cpu" and not plain:
        raise NotImplementedError(f"no RoIPool kernel for {features.device}")
    return roi_pool_reference(
        features, rois, spatial_scale, output_size, with_argmax=with_argmax
    )


class _RoIPool(torch.autograd.Function):
    """RoIPool with the argmax backward (the JAX package's custom VJP).
    The forward keeps only the int32 argmax for the backward; rois get no
    gradient (proposals are constants of the train step)."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, output_size, plain):
        out, argmax = _roi_pool_forward(
            features, rois, spatial_scale, output_size, True, plain
        )
        ctx.save_for_backward(argmax)
        ctx.features_shape = tuple(features.shape)
        ctx.features_dtype = features.dtype
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, grad):
        (argmax,) = ctx.saved_tensors
        dfeat = roi_pool_backward(
            grad, argmax, ctx.features_shape, ctx.features_dtype, plain=ctx.plain
        )
        return dfeat, None, None, None, None


def roi_pool_batch(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float = 1.0,
    output_size: int = 7,
    with_argmax: bool = False,
    plain: bool = False,
):
    """``features [B, C, h, w]``, ``rois [B, n, 4]`` -> ``[B, n, C, P, P]``.

    A CUDA tensor runs the hand kernels, a CPU tensor the plain versions.
    When ``features`` needs a gradient the call goes through an autograd
    function whose forward also writes the argmax and whose backward is
    :func:`roi_pool_backward`; otherwise (predict, ``no_grad``) it is the
    forward alone. ``plain=True`` is for tests only: it runs the plain
    versions on any device, so a caller can hold the kernels' path
    against them.
    """
    if torch.is_grad_enabled() and features.requires_grad and not with_argmax:
        return _RoIPool.apply(features, rois, spatial_scale, output_size, plain)
    return _roi_pool_forward(features, rois, spatial_scale, output_size, with_argmax, plain)

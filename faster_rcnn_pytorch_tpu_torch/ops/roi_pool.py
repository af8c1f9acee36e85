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

:func:`roi_pool_batch` dispatches (``ops/library.py::use_kernel``): a
CUDA tensor goes to the hand-written kernels (``ops/cuda/roi_pool.cu``)
and a CPU tensor to the plain versions,
:func:`roi_pool_reference` and :func:`roi_pool_backward_reference`. The
kernels hold channel planes in shared memory; :func:`forward_plan` and
:func:`backward_plan` cut the work into thread blocks. The
gradient w.r.t. the features adds each pooled cell's upstream gradient at
its argmax cell (ties went to the first max in the forward, as in the
TPU kernel; ``jax.grad`` of a plain max would split them). There is no
fallback: a build or launch failure on a CUDA tensor raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from faster_rcnn_pytorch_tpu_torch.ops.library import use_kernel  # also registers frcnn::*

# Rois gathered per step by the plain version (bounds its transient memory).
_ROI_CHUNK = 32

# The most dynamic shared memory one block may take on an H100 (sm_90).
SHARED_MEMORY_BYTES = 232_448
H100_SMS = 132
# Forward blocks each SM gets at least, where the shape allows: eight
# blocks of up to 256 threads fill an SM.
_BLOCKS_PER_SM = 8
# Channels a forward block stages: its warps' lanes take one bin of both
# channels, whose scans run the same trip counts.
_FORWARD_CHANNELS = 2
# The fewest rois a forward block walks when the rois are cut (unless the
# image has fewer): below it, staging the planes outweighs the scans.
_MIN_CHUNK_ROIS = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a RoIPool kernel cuts a ``[batch, channels, height, *]`` map and
    ``rois`` rois per image into thread blocks.

    A block owns one image, ``chunk_channels`` channels, ``band_rows`` rows
    and ``chunk_rois`` rois, and asks for ``shared_bytes`` of dynamic shared
    memory. The forward cuts the rois (its blocks hold whole planes); the
    backward cuts the rows into bands (its blocks walk every roi).
    ``shared_bytes == 0`` is the forward's direct-read route for a plane too
    large for shared memory: no blocks of its own, a thread per output.
    """

    batch: int
    channels: int
    height: int
    rois: int
    chunk_channels: int
    chunk_rois: int
    band_rows: int
    shared_bytes: int

    def blocks(self):
        """``(image, (c_lo, c_hi), (row_lo, row_hi), (roi_lo, roi_hi))`` of
        every block, in the kernels' ``blockIdx.x`` order."""
        for b in range(self.batch):
            for c in range(0, self.channels, self.chunk_channels):
                for r in range(0, max(self.rois, 1), self.chunk_rois):
                    for y in range(0, self.height, self.band_rows):
                        yield (
                            b,
                            (c, min(c + self.chunk_channels, self.channels)),
                            (y, min(y + self.band_rows, self.height)),
                            (r, min(r + self.chunk_rois, self.rois)),
                        )

    @property
    def grid(self) -> int:
        return (
            self.batch
            * _cdiv(self.channels, self.chunk_channels)
            * _cdiv(max(self.rois, 1), self.chunk_rois)
            * _cdiv(self.height, self.band_rows)
        )


@functools.lru_cache(maxsize=64)  # a few shapes a run; keeps the host path short
def forward_plan(
    batch: int,
    channels: int,
    height: int,
    width: int,
    rois: int,
    itemsize: int,
    pooled: int = 7,
    sms: int = H100_SMS,
) -> LaunchPlan:
    """The forward kernel's plan. A block stages ``_FORWARD_CHANNELS``
    channel planes (one where two leave no room for a roi; ``itemsize``
    bytes a cell, padded to 16 bytes) and the packed bin bounds of its rois
    (``2 * pooled`` int32 a roi). The rois are cut into as few chunks as
    give every SM ``_BLOCKS_PER_SM`` blocks, of at least
    ``_MIN_CHUNK_ROIS`` rois: each further chunk stages its planes again,
    from L2. A plane that leaves no room for one roi (or a side of 2^16
    cells, past the packed bounds) takes the direct-read route."""
    roi_bytes = 2 * pooled * 4

    def planes_bytes(n: int) -> int:
        return _cdiv(n * height * width * itemsize, 16) * 16

    if planes_bytes(1) + roi_bytes > SHARED_MEMORY_BYTES or max(height, width) >= 1 << 16:
        return LaunchPlan(batch, channels, height, rois, channels, max(rois, 1), height, 0)
    cc = min(_FORWARD_CHANNELS, channels)
    if planes_bytes(cc) + roi_bytes > SHARED_MEMORY_BYTES:
        cc = 1
    n = max(rois, 1)
    chunks = min(
        _cdiv(_BLOCKS_PER_SM * sms, batch * _cdiv(channels, cc)), _cdiv(n, _MIN_CHUNK_ROIS)
    )
    chunk_rois = min(_cdiv(n, chunks), (SHARED_MEMORY_BYTES - planes_bytes(cc)) // roi_bytes)
    return LaunchPlan(
        batch, channels, height, rois, cc, chunk_rois, height,
        planes_bytes(cc) + chunk_rois * roi_bytes,
    )


@functools.lru_cache(maxsize=64)
def backward_plan(batch: int, channels: int, height: int, width: int, rois: int) -> LaunchPlan:
    """The backward kernel's plan. A block sums one channel's float32
    plane in shared memory (two a block were slower at the train shape,
    PERF.md section 6). A plane larger than a block's shared memory is cut
    into bands of rows as even as can be, a block each: a block then adds
    only the entries whose argmax row lies in its band."""
    row_bytes = width * 4
    if row_bytes > SHARED_MEMORY_BYTES:
        raise ValueError(f"a row of {width} float32 cells exceeds one block's shared memory")
    rows = max(1, min(height, SHARED_MEMORY_BYTES // max(row_bytes, 1)))
    rows = _cdiv(height, _cdiv(height, rows)) if height else 1
    return LaunchPlan(batch, channels, height, rois, 1, max(rois, 1), rows, rows * row_bytes)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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

    # The map as [B*h*w, C] rows plus one row of -inf past its end: a window
    # position outside its bin reads that row, so no masking pass runs
    # over the gathered channels.
    cells = features.float().permute(0, 2, 3, 1).reshape(b * h * w, c)
    cells = torch.cat([cells, torch.full((1, c), float("-inf"), device=dev)])
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
        ok = row_ok[sl][:, :, None, :, None] & col_ok[sl][:, None, :, None, :]
        cell = (image[sl][:, None, None, None, None] * h + r_idx) * w + c_idx
        window = cells[torch.where(ok, cell, b * h * w)]  # [r, P, P, kh, kw, C]
        r = window.shape[0]
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
    arguments and results as :func:`roi_pool_reference`, cut into blocks by
    :func:`forward_plan`. Counts its launches in ``roi_pool_cuda.launches``."""
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
    b, c, h, w = features.shape
    n = rois.shape[1]
    p = output_size
    plan = forward_plan(b, c, h, w, n, features.element_size(), p, _sms(features.device))
    out = torch.empty((b * n, c, p, p), dtype=features.dtype, device=features.device)
    arg = torch.empty(
        (b * n, c, p, p) if with_argmax else (0,),
        dtype=torch.int32,
        device=features.device,
    )
    ext.roi_pool_forward(
        features.contiguous(),
        rois.contiguous(),
        float(spatial_scale),
        p,
        plan.chunk_channels,
        plan.chunk_rois,
        plan.shared_bytes,
        out,
        arg,
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
    arguments and result as :func:`roi_pool_backward_reference` for
    ``dtype`` float32 or bfloat16: float32 sums in shared memory, cut into
    blocks by :func:`backward_plan`, each cell written once in ``dtype``.
    Counts its launches in ``roi_pool_backward_cuda.launches``."""
    if not (grad.is_cuda and argmax.is_cuda):
        raise ValueError("roi_pool_backward_cuda needs CUDA tensors")
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grad must be float32 or bfloat16, not {grad.dtype}")
    if argmax.dtype != torch.int32 or argmax.shape != grad.shape or grad.dim() != 5:
        raise ValueError(
            f"want grad [B,n,C,P,P] and an int32 argmax of its shape, got "
            f"{tuple(grad.shape)} and {tuple(argmax.shape)} {argmax.dtype}"
        )
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, not {dtype}")
    b, c, h, w = features_shape
    if grad.shape[0] != b or grad.shape[2] != c:
        raise ValueError(f"grad {tuple(grad.shape)} does not match features {features_shape}")
    from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

    ext = extension()
    plan = backward_plan(b, c, h, w, grad.shape[1])
    dfeat = torch.empty((b, c, h, w), dtype=dtype, device=grad.device)
    ext.roi_pool_backward(
        grad.contiguous(),
        argmax.contiguous(),
        plan.chunk_channels,
        plan.band_rows,
        plan.shared_bytes,
        dfeat,
    )
    roi_pool_backward_cuda.launches += 1
    return dfeat


roi_pool_backward_cuda.launches = 0


def roi_pool_backward(grad, argmax, features_shape, dtype):
    """Features-gradient dispatch (``ops/library.py::use_kernel``): the
    hand kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if use_kernel(grad, "RoIPool backward"):
        return roi_pool_backward_cuda(grad, argmax, features_shape, dtype)
    return roi_pool_backward_reference(grad, argmax, features_shape, dtype)


class _RoIPool(torch.autograd.Function):
    """RoIPool with the argmax backward (the JAX package's custom VJP).
    The forward keeps only the int32 argmax for the backward, whose path
    is the forward's; rois get no gradient (proposals are constants of the
    train step)."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, output_size):
        ctx.kernel = use_kernel(features, "RoIPool")
        forward = roi_pool_cuda if ctx.kernel else roi_pool_reference
        out, argmax = forward(features, rois, spatial_scale, output_size, with_argmax=True)
        ctx.save_for_backward(argmax)
        ctx.features_shape = tuple(features.shape)
        ctx.features_dtype = features.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        (argmax,) = ctx.saved_tensors
        backward = roi_pool_backward_cuda if ctx.kernel else roi_pool_backward_reference
        return backward(grad, argmax, ctx.features_shape, ctx.features_dtype), None, None, None


def roi_pool_batch(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float = 1.0,
    output_size: int = 7,
    with_argmax: bool = False,
):
    """``features [B, C, h, w]``, ``rois [B, n, 4]`` -> ``[B, n, C, P, P]``.

    A CUDA tensor runs the hand kernels, a CPU tensor the plain versions.
    When ``features`` needs a gradient the call goes through an autograd
    function whose forward also writes the argmax and whose backward is
    the features-gradient kernel; otherwise (predict, ``no_grad``) it is the
    forward alone, the ``frcnn::roi_pool`` op (``ops/library.py``), which
    an exported program calls too.
    """
    if torch.is_grad_enabled() and features.requires_grad and not with_argmax:
        return _RoIPool.apply(features, rois, spatial_scale, output_size)
    if with_argmax:
        forward = roi_pool_cuda if use_kernel(features, "RoIPool") else roi_pool_reference
        return forward(features, rois, spatial_scale, output_size, with_argmax=True)
    return torch.ops.frcnn.roi_pool(features, rois, float(spatial_scale), int(output_size))

"""Port RoIPool against the JAX package, bit for bit.

The plain twin (``roi_pool_reference``, NCHW) is held against the JAX
lax twin ``roi_pool_lax`` and against the Pallas kernel in interpret mode
(``_roi_pool_pallas_impl`` / ``_roi_pool_batch_pallas_impl`` with
``with_argmax=True``), NHWC <-> NCHW transposed. The Pallas argmax
flattens as ``row * w_pad + col`` with ``w_pad`` rounded up to 8; it is
converted to the port's ``row * w + col``. The CUDA kernel itself is
held against the twin on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.ops.pallas.roi_pool_kernel import (
    _roi_pool_batch_pallas_impl,
    _roi_pool_pallas_impl,
)
from faster_rcnn_pytorch_tpu.ops.roi_pool import roi_pool_lax
from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as prp
from tests.test_roi_ops import np_roi_pool, rand_rois


def _rois(rs, n, h, w):
    rois = rand_rois(rs, n, h, w)
    edge = np.array(
        [
            [0, 0, 0.4, 0.4],  # degenerate, one cell
            [w - 0.4, h - 0.4, w, h],  # touching the far border
            [0, 0, w, h],  # extent = size + 1
            [2.5, 1.5, 5.5, 4.5],  # .5 corners: half to even
            [3.5, 0.5, 3.5, 2.5],  # zero width, .5 corners
            [1.5, 2.5, w - 0.5, h - 1.5],
        ],
        np.float32,
    )
    return np.concatenate([rois, edge]).astype(np.float32)


def _nchw(feat_hwc):
    return torch.tensor(np.ascontiguousarray(feat_hwc.transpose(2, 0, 1)))[None]


def _to_nhwc(pooled):  # port [1, n, C, P, P] -> [n, P, P, C]
    return pooled[0].permute(0, 2, 3, 1).numpy()


def _convert_argmax(arg, w):
    w_pad = -(-w // 8) * 8
    arg = np.asarray(arg).astype(np.int64)
    out = (arg // w_pad) * w + arg % w_pad
    return np.where(arg < 0, -1, out)


@pytest.mark.parametrize("h,w,c,n", [(50, 38, 6, 23), (12, 12, 3, 5), (16, 21, 8, 30)])
def test_reference_matches_lax_and_numpy(h, w, c, n):
    rs = np.random.RandomState(h * w)
    feat = rs.normal(size=(h, w, c)).astype(np.float32)
    rois = _rois(rs, n, h, w)
    want = np.asarray(roi_pool_lax(jnp.asarray(feat), jnp.asarray(rois), 1.0))
    got = prp.roi_pool_reference(_nchw(feat), torch.tensor(rois)[None], 1.0)
    np.testing.assert_array_equal(_to_nhwc(got), want)
    np.testing.assert_array_equal(_to_nhwc(got), np_roi_pool(feat, rois, 1.0).astype(np.float32))


@pytest.mark.parametrize("scale", [1.0, 1.0 / 16])
def test_reference_matches_pallas_kernel_with_argmax(scale):
    rs = np.random.RandomState(11)
    h, w, c = 14, 19, 8
    feat = rs.normal(size=(h, w, c)).astype(np.float32)
    feat[3:6, 4:9] = 2.0  # plateaus: ties go to the first max
    rois = _rois(rs, 17, h, w) / scale
    want, want_arg = _roi_pool_pallas_impl(
        jnp.asarray(feat), jnp.asarray(rois), scale, 7, True, True
    )
    got, got_arg = prp.roi_pool_reference(
        _nchw(feat), torch.tensor(rois)[None], scale, with_argmax=True
    )
    np.testing.assert_array_equal(_to_nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(
        got_arg[0].permute(0, 2, 3, 1).numpy(), _convert_argmax(want_arg, w)
    )


def test_reference_matches_batched_pallas_kernel_bf16():
    rs = np.random.RandomState(5)
    b, h, w, c, n = 2, 13, 17, 8, 9
    feat = rs.normal(size=(b, h, w, c)).astype(np.float32)
    rois = np.stack([_rois(rs, n, h, w) for _ in range(b)])
    feat_bf16 = jnp.asarray(feat).astype(jnp.bfloat16)
    want, want_arg = _roi_pool_batch_pallas_impl(
        feat_bf16, jnp.asarray(rois), 1.0, 7, True, True
    )
    nchw = torch.tensor(np.asarray(feat_bf16.astype(jnp.float32))).permute(0, 3, 1, 2)
    got, got_arg = prp.roi_pool_reference(
        nchw.to(torch.bfloat16).contiguous(), torch.tensor(rois), 1.0, with_argmax=True
    )
    assert got.dtype == torch.bfloat16 and got.shape == (b, rois.shape[1], c, 7, 7)
    np.testing.assert_array_equal(
        got.float().permute(0, 1, 3, 4, 2).numpy(), np.asarray(want.astype(jnp.float32))
    )
    np.testing.assert_array_equal(
        got_arg.permute(0, 1, 3, 4, 2).numpy(), _convert_argmax(want_arg, w)
    )


def test_batch_dispatch_on_cpu_uses_the_plain_version():
    rs = np.random.RandomState(1)
    feat = torch.tensor(rs.normal(size=(2, 4, 9, 11)).astype(np.float32))
    rois = torch.tensor(np.stack([_rois(rs, 4, 9, 11) for _ in range(2)]))
    before = prp.roi_pool_cuda.launches
    out = prp.roi_pool_batch(feat, rois, 1.0, 7)
    assert torch.equal(out, prp.roi_pool_reference(feat, rois, 1.0, 7))
    assert prp.roi_pool_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        prp.roi_pool_cuda(feat, rois)  # no silent CPU path in the kernel wrapper


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_at_predict_shape(dtype):
    g = torch.Generator().manual_seed(0)
    feats = torch.relu(torch.randn(1, 512, 50, 84, generator=g)).to("cuda", dtype)
    xy = torch.rand(1, 300, 2, generator=g) * torch.tensor([80.0, 46.0])
    wh = torch.rand(1, 300, 2, generator=g) * torch.tensor([40.0, 30.0])
    rois = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([84.0, 50.0]))], -1)
    rois[0, :6] = torch.tensor(_rois(np.random.RandomState(0), 0, 50, 84))
    rois = rois.cuda()
    before = prp.roi_pool_cuda.launches
    out, arg = prp.roi_pool_batch(feats, rois, 1.0, 7, with_argmax=True)
    torch.cuda.synchronize()
    assert prp.roi_pool_cuda.launches == before + 1
    ref, ref_arg = prp.roi_pool_reference(feats, rois, 1.0, 7, with_argmax=True)
    assert torch.equal(out, ref) and torch.equal(arg, ref_arg)

"""The port's RoIPool backward against the JAX package's Pallas backward.

The Pallas kernel runs in interpret mode through ``jax.grad`` of
``roi_pool_pallas_batch(..., interpret=True)``, as
``tests/test_pallas_kernels.py`` drives it. Both kernels give a tied bin's
gradient to its first max, so the features hold plateaus; ``jax.grad`` of
the plain lax max would split a tie evenly and is no oracle there. Rois
lie inside the map (the Pallas kernel's static window assumes so).

Tolerances: integer-valued upstream gradients make every float32 sum
exact, so the port must be identical; normal gradients within atol 1e-5
(sums in another order). The autograd function's CPU backward agrees
with autograd through the plain forward on tie-free inputs (atol 1e-5,
the same reason). The CUDA kernel is
held against the plain version on the card (skipped without one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.ops.pallas.roi_pool_kernel import roi_pool_pallas_batch
from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as prp
from tests.test_roi_ops import rand_rois


def _inputs(seed, b=2, h=13, w=17, c=8, n=9):
    rs = np.random.RandomState(seed)
    feat = rs.normal(size=(b, h, w, c)).astype(np.float32)
    feat[:, 3:7, 4:10] = 2.5  # plateaus: ties go to the first max
    feat[:, 8:, :5] = 0.0
    rois = np.stack([rand_rois(rs, n, h, w) for _ in range(b)])
    rois[:, 0] = [0, 0, w, h]  # the whole map
    rois[:, 1] = [4.5, 3.5, 9.5, 6.5]  # inside a plateau, .5 corners
    rois[:, 2] = [1.2, 1.2, 1.4, 1.4]  # one cell
    return rs, feat, rois


def _pallas_grad(feat, rois, g):
    def loss(f):
        return (roi_pool_pallas_batch(f, jnp.asarray(rois), 1.0, 7, True) * g).sum()

    return np.asarray(jax.grad(loss)(jnp.asarray(feat)))


def _port_grad(feat, rois, g):
    f = torch.tensor(feat).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = prp.roi_pool_batch(f, torch.tensor(rois), 1.0, 7)
    (out * torch.tensor(g).permute(0, 1, 4, 2, 3)).sum().backward()
    return f.grad.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("integer_grads", [True, False])
def test_backward_matches_pallas_kernel(integer_grads):
    rs, feat, rois = _inputs(3)
    shape = rois.shape[:2] + (7, 7, feat.shape[-1])
    if integer_grads:
        g = rs.randint(-3, 4, size=shape).astype(np.float32)
    else:
        g = rs.normal(size=shape).astype(np.float32)
    want = _pallas_grad(feat, rois, g)
    before = prp.roi_pool_backward_cuda.launches
    got = _port_grad(feat, rois, g)
    assert prp.roi_pool_backward_cuda.launches == before  # CPU: the plain version
    assert np.abs(want).max() > 1.0
    if integer_grads:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reference_backward_direct_and_bf16():
    rs, feat, rois = _inputs(4, n=5)
    f = torch.tensor(feat).permute(0, 3, 1, 2).contiguous()
    _, arg = prp.roi_pool_reference(f, torch.tensor(rois), 1.0, 7, with_argmax=True)
    g = torch.tensor(rs.randint(-3, 4, size=arg.shape).astype(np.float32))
    want = _pallas_grad(feat, rois, g.permute(0, 1, 3, 4, 2).numpy())
    got = prp.roi_pool_backward_reference(g, arg, tuple(f.shape), torch.float32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # bf16 upstream gradient: widened, summed in float32, cast to bf16
    got16 = prp.roi_pool_backward(g.to(torch.bfloat16), arg, tuple(f.shape), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_function_backward_matches_autograd_of_plain_forward():
    rs = np.random.RandomState(8)
    feat = torch.tensor(rs.normal(size=(2, 6, 11, 15)).astype(np.float32))  # tie-free
    rois = torch.tensor(np.stack([rand_rois(rs, 7, 11, 15) for _ in range(2)]))
    g = torch.tensor(rs.normal(size=(2, 7, 6, 7, 7)).astype(np.float32))

    f1 = feat.clone().requires_grad_(True)
    out1 = prp.roi_pool_batch(f1, rois, 1.0, 7)
    assert out1.grad_fn is not None and "RoIPool" in type(out1.grad_fn).__name__
    (out1 * g).sum().backward()

    f2 = feat.clone().requires_grad_(True)
    out2 = prp.roi_pool_reference(f2, rois, 1.0, 7)
    (out2 * g).sum().backward()

    assert torch.equal(out1, out2)
    torch.testing.assert_close(f1.grad, f2.grad, rtol=0, atol=1e-5)  # sum order
    assert rois.grad is None


def test_no_grad_forward_skips_the_autograd_function():
    rs = np.random.RandomState(2)
    feat = torch.tensor(rs.normal(size=(1, 4, 9, 9)).astype(np.float32)).requires_grad_(True)
    rois = torch.tensor(rand_rois(rs, 3, 9, 9))[None]
    with torch.no_grad():
        out = prp.roi_pool_batch(feat, rois, 1.0, 7)
    assert out.grad_fn is None
    assert torch.equal(out, prp.roi_pool_reference(feat.detach(), rois, 1.0, 7))


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    g = torch.zeros(1, 2, 3, 7, 7)
    with pytest.raises(ValueError, match="CUDA"):
        prp.roi_pool_backward_cuda(g, torch.zeros(g.shape, dtype=torch.int32), (1, 3, 5, 5), torch.float32)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_kernel_matches_plain_at_train_shape(dtype):
    g = torch.Generator().manual_seed(0)
    b, c, h, w, n = 2, 512, 50, 84, 128
    feats = torch.relu(torch.randn(b, c, h, w, generator=g)).to("cuda", dtype)
    xy = torch.rand(b, n, 2, generator=g) * torch.tensor([w - 4.0, h - 4.0])
    wh = torch.rand(b, n, 2, generator=g) * torch.tensor([w / 2.0, h / 2.0])
    rois = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w * 1.0, h * 1.0]))], -1)
    rois = rois.to("cuda")
    _, arg = prp.roi_pool_cuda(feats, rois, 1.0, 7, with_argmax=True)
    grad = torch.randint(-3, 4, (b, n, c, 7, 7), generator=g).to("cuda", dtype)
    before = prp.roi_pool_backward_cuda.launches
    got = prp.roi_pool_backward(grad, arg, tuple(feats.shape), dtype)
    torch.cuda.synchronize()
    assert prp.roi_pool_backward_cuda.launches == before + 1
    want = prp.roi_pool_backward_reference(grad, arg, tuple(feats.shape), dtype)
    assert got.dtype == dtype and torch.equal(got, want)

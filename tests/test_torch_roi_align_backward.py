"""The port's MultiScaleRoIAlign backward against the JAX package.

The plain backward (``multiscale_roi_align_backward_reference``) is the
exact adjoint for every roi; the JAX package splits it into the window
kernel for rois that fit and a dense-matmul VJP for those that do not.
It is held against:

* the Pallas backward ``roi_window_align_bwd(..., interpret=True)`` with
  the non-fitting rois' gradient zeroed on both sides, and ``jax.vjp`` of
  ``multiscale_roi_align_dense`` with the same zeroed gradient and with the
  full one, on the fuzz set and overlap clump of
  ``test_roi_ops.test_roi_window_bwd_kernel_matches_dense_vjp_fuzz``
  (2 images x 40 rois, C = 6), and on its odd count (13 rois of one
  image): ``max|d| <= 1e-5 * max|ref|`` per level (sums in other orders);
* the whole custom VJP of JAX's ``multiscale_roi_align_batch`` under
  ``FRT_ALIGN_KERNEL=interpret`` (kernel plus compacted dense fallback) at
  C = 128, as ``test_roi_ops.test_msra_batch_vjp_kernel_composition``
  drives it, through the port's autograd function: the same tolerance;
* ``torch.autograd.grad`` through the plain forward
  ``multiscale_roi_align_reference``: the same tolerance, and bit for bit
  on rois whose every weight is a multiple of 1/16 with integer
  gradients (``chip_smoke.exact_align_rois``), where every order of
  addition gives the same float32 sum.

The autograd function on the CPU launches neither kernel; the CUDA
wrapper refuses CPU tensors. On a card only (skipped here): the kernel
against the plain version, bit for bit on the exact set in float32 and
bfloat16, within ``1e-5 * max|ref|`` otherwise; and on the footprints that
stress its per-roi lists (``chip_smoke.footprint_rois``: giant rois on
P5, rois partly and wholly outside, degenerate rois, 64 rois sharing one
cell) within ``1e-5 * max|ref|``, bit for bit on 40 copies of one dyadic
roi with integer gradients.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from faster_rcnn_pytorch_tpu.ops.pallas.roi_window_kernel import roi_window_align_bwd
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra

# ``faster_rcnn_pytorch_tpu.ops`` exports a function named ``roi_align``.
jra = importlib.import_module("faster_rcnn_pytorch_tpu.ops.roi_align")
STRIDES = (4, 8, 16, 32)


def _close(got, want, rel=1e-5):
    """Per level: ``max|d| <= rel * max|ref|`` (NHWC JAX maps)."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
        assert err <= rel * np.abs(w).max(), (err, np.abs(w).max())


def _plain_bwd(g_nhwc, rois, shapes):
    """The port's plain backward on JAX-layout ``g [B, n, 7, 7, C]``."""
    r = torch.tensor(np.asarray(rois))
    g = torch.tensor(np.asarray(g_nhwc)).permute(0, 1, 4, 2, 3)
    return pra.multiscale_roi_align_backward_reference(
        g, r, pra.fpn_level_assignment(r), shapes, torch.float32
    )


def _dense_vjp(feats, rois, g):
    _, vjp = jax.vjp(
        lambda f: jax.vmap(lambda f2, r: jra.multiscale_roi_align_dense(f2, r))(f, rois), feats
    )
    return vjp(g)[0]


@pytest.fixture(scope="module")
def fuzz():
    """``test_roi_ops``'s fuzz set: per image 28 log-uniform rois, a clump
    of 8 near-identical ones, and 4 extremes; levels 64x72 .. 8x16."""
    rs = np.random.RandomState(7)
    feats = tuple(
        jnp.asarray(rs.normal(size=(2, s, s + 8, 6)).astype(np.float32)) for s in (64, 32, 16, 8)
    )
    rois_imgs = []
    for _ in range(2):
        xy1 = rs.uniform(-10, 250, size=(28, 2))
        wh = np.exp(rs.uniform(np.log(2), np.log(500), size=(28, 2)))
        r = np.concatenate([xy1, xy1 + wh], axis=1)
        clump = np.tile(np.array([[40.0, 40.0, 120.0, 120.0]]), (8, 1))
        clump += rs.uniform(-3, 3, size=clump.shape)
        extremes = np.array([[0, 0, 288, 10], [0, 0, 10, 256], [200, 200, 1000, 1000], [0, 0, 288, 256]])
        rois_imgs.append(np.concatenate([r, clump, extremes]))
    rois = jnp.asarray(np.stack(rois_imgs).astype(np.float32))
    g = jnp.asarray(rs.normal(size=(*rois.shape[:2], 7, 7, 6)).astype(np.float32))
    shapes = [tuple(f.shape[1:3]) for f in feats]
    return feats, rois, g, shapes


@pytest.mark.parametrize("count", [40, 13], ids=["all", "odd"])
def test_plain_backward_matches_jax_window_kernel_and_dense_vjp(fuzz, count):
    feats, rois, g, shapes = fuzz
    if count == 13:  # the interleaved ordering's uneven split
        feats, rois, g = tuple(f[:1] for f in feats), rois[:1, :13], g[:1, :13]
    dfs, fits = roi_window_align_bwd(g, rois, tuple(shapes), interpret=True)
    gz = g * fits[..., None, None, None].astype(g.dtype)
    got = _plain_bwd(gz, rois, shapes)
    _close(got, dfs)
    _close(got, _dense_vjp(feats, rois, gz))
    # every roi, fitting or not: the exact adjoint without a fallback
    if count == 40:
        assert bool(fits.sum()) > 0 and bool((~fits).sum()) > 0
    _close(_plain_bwd(g, rois, shapes), _dense_vjp(feats, rois, g))


def test_autograd_matches_the_jax_custom_vjp_through_the_interpret_kernel(monkeypatch):
    monkeypatch.setenv("FRT_ALIGN_KERNEL", "interpret")
    rs = np.random.RandomState(11)
    feats = tuple(
        rs.normal(size=(1, s, s, 128)).astype(np.float32) * 0.1 for s in (32, 16, 8, 4)
    )
    xy1 = rs.uniform(0, 80, size=(10, 2))
    wh = np.exp(rs.uniform(np.log(4), np.log(120), size=(10, 2)))
    r = np.concatenate([xy1, xy1 + wh], axis=1)
    extremes = np.array([[0, 0, 127, 6], [0, 0, 900, 900]])
    rois = np.concatenate([r, extremes])[None].astype(np.float32)
    g = rs.normal(size=(1, 12, 7, 7, 128)).astype(np.float32)

    _, vjp = jax.vjp(
        lambda f: jra.multiscale_roi_align_batch(f, jnp.asarray(rois), STRIDES, 7, 2),
        tuple(jnp.asarray(f) for f in feats),
    )
    want = vjp(jnp.asarray(g))[0]

    pfeats = [torch.tensor(f).permute(0, 3, 1, 2).contiguous().requires_grad_(True) for f in feats]
    out = pra.multiscale_roi_align_batch(pfeats, torch.tensor(rois))
    got = torch.autograd.grad(out, pfeats, torch.tensor(g).permute(0, 1, 4, 2, 3))
    _close(got, want)


def _autograd_of_plain_forward(feats, rois, g):
    feats = [f.detach().clone().requires_grad_(True) for f in feats]
    out = pra.multiscale_roi_align_reference(feats, rois, pra.fpn_level_assignment(rois))
    return torch.autograd.grad(out, feats, g, allow_unused=True, materialize_grads=True)


def test_plain_backward_equals_autograd_through_the_plain_forward(fuzz):
    feats_nhwc, rois, g, shapes = fuzz
    feats = [torch.tensor(np.asarray(f)).permute(0, 3, 1, 2) for f in feats_nhwc]
    r = torch.tensor(np.asarray(rois))
    gt = torch.tensor(np.asarray(g)).permute(0, 1, 4, 2, 3)
    want = _autograd_of_plain_forward(feats, r, gt)
    _close(_plain_bwd(g, rois, shapes), [w.permute(0, 2, 3, 1).numpy() for w in want])


def test_exact_set_is_bit_exact_in_any_order():
    """On ``chip_smoke.exact_align_rois`` (the set the chip holds the
    kernel to bit for bit) with integer gradients, the plain backward and
    autograd through the plain forward (sums in different orders) agree
    bit for bit, in float32 and after the bfloat16 cast."""
    canvas = (256, 320)
    gen = torch.Generator().manual_seed(0)
    rois = chip_smoke.exact_align_rois(gen, 60, canvas)
    level = pra.fpn_level_assignment(rois)
    assert torch.bincount(level.flatten(), minlength=4).min() > 0  # every level
    shapes = chip_smoke._align_level_shapes(canvas)
    feats = [torch.zeros(2, 4, h, w) for h, w in shapes]
    g = torch.randint(-3, 4, (2, 60, 4, 7, 7), generator=gen).float()
    want = _autograd_of_plain_forward(feats, rois, g)
    got = pra.multiscale_roi_align_backward_reference(g, rois, level, shapes, torch.float32)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and a.abs().max() > 0
    got16 = pra.multiscale_roi_align_backward_reference(
        g.to(torch.bfloat16), rois, level, shapes, torch.bfloat16
    )
    for a, b in zip(got16, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


def test_autograd_function_on_the_cpu_launches_nothing(fuzz):
    feats_nhwc, rois, g, shapes = fuzz
    feats = [torch.tensor(np.asarray(f)).permute(0, 3, 1, 2).requires_grad_(True) for f in feats_nhwc]
    r = torch.tensor(np.asarray(rois))
    gt = torch.tensor(np.asarray(g)).permute(0, 1, 4, 2, 3)
    before = (pra.multiscale_roi_align_cuda.launches, pra.multiscale_roi_align_backward_cuda.launches)
    out = pra.multiscale_roi_align_batch(feats, r)
    got = torch.autograd.grad(out, feats, gt)
    after = (pra.multiscale_roi_align_cuda.launches, pra.multiscale_roi_align_backward_cuda.launches)
    assert after == before
    want = pra.multiscale_roi_align_backward_reference(gt, r, pra.fpn_level_assignment(r), shapes, torch.float32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # predict: no gradient wanted, the same forward
    with torch.no_grad():
        assert torch.equal(pra.multiscale_roi_align_batch(feats, r), out.detach())


def test_cuda_wrapper_refuses_cpu_tensors(fuzz):
    _, rois, g, shapes = fuzz
    r = torch.tensor(np.asarray(rois))
    gt = torch.tensor(np.asarray(g)).permute(0, 1, 4, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        pra.multiscale_roi_align_backward_cuda(gt, r, pra.fpn_level_assignment(r), shapes, torch.float32)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(dtype):
    canvas = (384, 448)
    gen = torch.Generator().manual_seed(1)
    shapes = chip_smoke._align_level_shapes(canvas)
    exact = chip_smoke.exact_align_rois(gen, 40, canvas).cuda()
    level = pra.fpn_level_assignment(exact)
    ints = torch.randint(-3, 4, (2, 40, 64, 7, 7), generator=gen).to("cuda", dtype)
    before = pra.multiscale_roi_align_backward_cuda.launches
    got = pra.multiscale_roi_align_backward(ints, exact, level, shapes, dtype)
    torch.cuda.synchronize()
    assert pra.multiscale_roi_align_backward_cuda.launches == before + 1
    want = pra.multiscale_roi_align_backward(ints, exact, level, shapes, dtype, plain=True)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    rois = chip_smoke._align_rois(gen, 40, canvas).cuda()
    level = pra.fpn_level_assignment(rois)
    normal = torch.randn(ints.shape, generator=gen).to("cuda", dtype)
    got = pra.multiscale_roi_align_backward_cuda(normal, rois, level, shapes, torch.float32)
    want = pra.multiscale_roi_align_backward_reference(normal, rois, level, shapes, torch.float32)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain_on_footprint_edges(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    canvas = (384, 448)
    gen = torch.Generator().manual_seed(4)
    shapes = chip_smoke._align_level_shapes(canvas)
    rois = chip_smoke.footprint_rois(gen, 96, canvas).cuda()
    level = pra.fpn_level_assignment(rois)
    normal = torch.randn(2, 96, 64, 7, 7, generator=gen).to("cuda", dtype)
    got = pra.multiscale_roi_align_backward_cuda(normal, rois, level, shapes, torch.float32)
    want = pra.multiscale_roi_align_backward_reference(normal, rois, level, shapes, torch.float32)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    # many blocks adding into the same cells, in an order that varies
    exact = chip_smoke.exact_align_rois(gen, 96, canvas)
    exact[:, 8:48] = exact[:, :1]
    exact = exact.cuda()
    level = pra.fpn_level_assignment(exact)
    ints = torch.randint(-3, 4, normal.shape, generator=gen).to("cuda", dtype)
    got = pra.multiscale_roi_align_backward_cuda(ints, exact, level, shapes, dtype)
    want = pra.multiscale_roi_align_backward_reference(ints, exact, level, shapes, dtype)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)

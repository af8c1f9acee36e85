"""The port's MultiScaleRoIAlign against the JAX package.

* ``fpn_level_assignment``: equal to JAX's, exactly, including areas on
  the level boundaries (sqrt(area) = 112, 224, 448) and zero-area rois.
* The plain version against the JAX window kernel run as the JAX tests
  run it (``_batch_window_kernel(..., interpret=True)``, C = 256 so the
  lane gate passes) and against ``multiscale_roi_align_dense``, on level
  maps larger than the kernel's 40-cell window (P2 96x112), with the
  extremes of ``test_roi_ops`` (banner, pole, degenerate, clamped-level
  giant, whole canvas) and rois partly outside the canvas: some rois do
  not fit the window, so the JAX corner fallback runs.
* Float32 within ``1e-5 * max|ref|``. bfloat16 against JAX's bfloat16
  within one bfloat16 ulp of the float32 result plus that float32
  tolerance: both round a float32 sum, but the two sums differ in their
  last bits, and where the samples cancel to near zero (one element of
  1.1M here: 1.68e-8 against 1.40e-8) that difference is many ulps of the
  tiny result.
* The dispatch: a CPU tensor takes the plain version and launches
  nothing; the kernel wrapper refuses CPU tensors.
* On a card only (skipped here): the kernel against the plain version,
  bit for bit, float32 and bfloat16, on the fixture's rois and on
  ``chip_smoke.footprint_rois`` (the footprints that stress the kernel's
  per-roi geometry: giant rois on P5, rois partly and wholly outside,
  degenerate rois, 64 rois sharing one cell).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from faster_rcnn_pytorch_tpu.ops.roi_align import (
    _batch_window_kernel,
    fpn_level_assignment as jax_levels,
    multiscale_roi_align_dense,
)
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra

STRIDES = (4, 8, 16, 32)
CANVAS = (384, 448)  # P2 96x112: larger than the kernel's 40-cell window
C = 256


def _rois(rs, n, canvas=CANVAS):
    h, w = canvas
    xy1 = rs.uniform(-10, w - 20, size=(n, 2))
    wh = np.exp(rs.uniform(np.log(2), np.log(500), size=(n, 2)))
    r = np.concatenate([xy1, xy1 + wh], axis=1)
    extremes = np.array(
        [
            [0, 0, w, 10],  # full-width banner: overflows the window in x
            [0, 0, 10, h],  # full-height pole: overflows it in y
            [5, 5, 5.2, 5.2],  # degenerate
            [200, 200, 1000, 1000],  # clamped-level giant
            [0, 0, w, h],  # whole canvas
            [-30, -20, 40, 50],  # partly outside, top left
            [w - 50, h - 40, w + 60, h + 30],  # partly outside, bottom right
            [-80, 100, -10, 160],  # wholly left of the canvas
        ]
    )
    return np.concatenate([r, extremes]).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(7)
    h, w = CANVAS
    feats = [rs.normal(size=(2, -(-h // s), -(-w // s), C)).astype(np.float32) for s in STRIDES]
    rois = np.stack([_rois(rs, 37) for _ in range(2)])
    return feats, rois


def _port(feats_nhwc, rois, dtype=torch.float32):
    feats = [torch.tensor(f).permute(0, 3, 1, 2).contiguous().to(dtype) for f in feats_nhwc]
    out = pra.multiscale_roi_align_batch(feats, torch.tensor(rois))
    assert out.dtype == dtype and out.shape == (*rois.shape[:2], C, 7, 7)
    return out.float().permute(0, 1, 3, 4, 2).numpy()  # -> [B, n, 7, 7, C]


def _jax_kernel(feats_nhwc, rois, dtype=jnp.float32):
    feats = tuple(jnp.asarray(f, dtype) for f in feats_nhwc)
    return _batch_window_kernel(feats, jnp.asarray(rois), STRIDES, 7, 2, interpret=True)


def test_level_assignment_matches_jax_exactly():
    rs = np.random.RandomState(0)
    sides = np.array([0.0, 1e-3, 1.0, 111.9999, 112.0, 112.0001, 223.99998, 224.0, 224.00002,
                      447.9999, 448.0, 448.0001, 1000.0, 5000.0], np.float32)
    side_rois = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides, sides], 1)
    wide = np.stack(
        [np.full(6, 3.0), np.full(6, 2.0), [3, 3, 227, 451, 3, 10], [2, 226, 2, 450, 2, 0]], 1
    ).astype(np.float32)  # zero-area lines and a reversed box
    random = _rois(rs, 200)
    for rois in (side_rois, wide, random):
        want = np.asarray(jax_levels(jnp.asarray(rois)))
        got = pra.fpn_level_assignment(torch.tensor(rois))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the boundaries land where the formula says (eps inside the log)
    got = pra.fpn_level_assignment(torch.tensor(side_rois)).tolist()
    assert got[4] == 1 and got[7] == 2 and got[10] == 3 and got[0] == 0


def test_plain_matches_jax_window_kernel_and_dense_float32(inputs):
    feats, rois = inputs
    from faster_rcnn_pytorch_tpu.ops.pallas.roi_window_kernel import roi_window_align

    _, fits = roi_window_align(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), STRIDES, 7, 2, interpret=True
    )
    assert not bool(np.asarray(fits).all()), "every roi fits: the JAX fallback is not exercised"
    got = _port(feats, rois)
    kernel = np.asarray(_jax_kernel(feats, rois))
    dense = np.asarray(
        jax.vmap(lambda f, r: multiscale_roi_align_dense(f, r))(
            tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois)
        )
    )
    for want in (kernel, dense):
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


def test_plain_matches_jax_window_kernel_bfloat16(inputs):
    feats, rois = inputs
    feats = [np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32)) for f in feats]
    got = _port(feats, rois, torch.bfloat16)
    want = np.asarray(_jax_kernel(feats, rois, jnp.bfloat16).astype(jnp.float32))
    exact = _port(feats, rois)  # the float32 result on the same (bf16-exact) inputs
    mag = np.maximum(np.abs(exact), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)  # bfloat16 keeps 8 significant bits
    tol = ulp + 1e-5 * np.abs(exact).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    assert (np.abs(got - exact) <= ulp).all()


def test_dispatch_on_cpu_takes_the_plain_version(inputs):
    feats_nhwc, rois = inputs
    feats = [torch.tensor(f).permute(0, 3, 1, 2) for f in feats_nhwc]
    r = torch.tensor(rois)
    level = pra.fpn_level_assignment(r)
    before = pra.multiscale_roi_align_cuda.launches
    out = pra.multiscale_roi_align_batch(feats, r)
    assert torch.equal(out, pra.multiscale_roi_align_reference(feats, r, level))
    assert pra.multiscale_roi_align_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pra.multiscale_roi_align_cuda(feats, r, level)  # no silent CPU path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_bit_for_bit(inputs, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    feats_nhwc, rois = inputs
    feats = [torch.tensor(f).permute(0, 3, 1, 2).contiguous().to("cuda", dtype) for f in feats_nhwc]
    r = torch.tensor(rois).cuda()
    before = pra.multiscale_roi_align_cuda.launches
    out = pra.multiscale_roi_align_batch(feats, r)
    torch.cuda.synchronize()
    assert pra.multiscale_roi_align_cuda.launches == before + 1
    ref = pra.multiscale_roi_align_batch(feats, r, plain=True)
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_footprint_edges(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator().manual_seed(2)
    shapes = chip_smoke._align_level_shapes(CANVAS)
    feats = [torch.randn(2, C, h, w, generator=gen).to("cuda", dtype) for h, w in shapes]
    r = chip_smoke.footprint_rois(gen, 96, CANVAS).cuda()
    level = pra.fpn_level_assignment(r)
    out = pra.multiscale_roi_align_cuda(feats, r, level)
    torch.cuda.synchronize()
    assert torch.equal(out, pra.multiscale_roi_align_reference(feats, r, level))

"""The port's slot-lattice MultiScaleRoIAlign (``multiscale_roi_align_slots``)
against the JAX package's ``multiscale_roi_align_pallas``.

* The plain version against the Pallas kernel run as the JAX tests run it
  (``interpret=True``), image by image, NHWC against the port's NCHW, on
  the fuzz set of ``tests/test_roi_ops.py``'s
  ``test_multiscale_pallas_matches_dense_fuzz`` (levels 64x72 .. 8x16, 40
  random rois, a banner and a pole spanning many slots, a degenerate roi,
  a clamped-level giant, the whole canvas) plus rois partly or wholly
  outside the canvas: within ``1e-5 * max|ref|``. Measured: 1.41e-5 at
  max|ref| 2.415 (5,378 of 13,230 elements differ): the jitted JAX
  function is compiled by XLA, which on the CPU fuses the sample
  coordinates into FMAs inside the fusion that takes their fraction, so
  its bilinear weights differ from the coordinates' own rounding by up to
  2**-18; the port keeps one rounding per operation, as its kernel does.
* Against the forward's plain version (``multiscale_roi_align_reference``,
  the same function in another order): within ``1e-6 * max|ref|``
  (measured 2.4e-7 at max|ref| 2.415 on the fuzz set).
* bfloat16 maps: within one bfloat16 ulp of the float32 result on the
  same (bfloat16-exact) inputs, as the forward's bfloat16 test holds it.
* A level map under 2x2 raises; the CPU takes the plain version and
  launches nothing; the kernel wrapper refuses CPU tensors.
* On a card only (skipped here): the kernel against the plain version,
  bit for bit, float32 and bfloat16, on the fuzz set and on
  ``chip_smoke.footprint_rois`` (giant, outside, degenerate and clumped
  rois: the kernel shares the forward's per-roi skeleton).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from faster_rcnn_pytorch_tpu.ops.pallas.roi_align_kernel import multiscale_roi_align_pallas
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra

SIZES = (64, 32, 16, 8)  # tests/test_roi_ops.py's levels: [s, s + 8] each


@pytest.fixture(scope="module")
def fuzz():
    """Two images of test_roi_ops' fuzz set (its seed for the first),
    NHWC maps [2, s, s + 8, 6] and rois [2, 48, 4] in image pixels."""
    images = []
    for seed in (19, 20):
        rs = np.random.RandomState(seed)
        feats = [rs.normal(size=(s, s + 8, 6)).astype(np.float32) for s in SIZES]
        xy1 = rs.uniform(-10, 250, size=(40, 2))
        wh = np.exp(rs.uniform(np.log(2), np.log(500), size=(40, 2)))
        extremes = [
            [0, 0, 288, 10],  # full-width banner: many x slots at P2
            [0, 0, 10, 256],  # full-height pole: many y slots
            [5, 5, 5.2, 5.2],  # degenerate
            [200, 200, 1000, 1000],  # clamped-level giant
            [0, 0, 288, 256],  # whole canvas
            [-30, -20, 40, 50],  # partly outside, top left
            [250, 220, 340, 300],  # partly outside, bottom right
            [-80, 100, -10, 160],  # wholly left of the canvas
        ]
        rois = np.concatenate([xy1, xy1 + wh], axis=1)
        images.append((feats, np.concatenate([rois, extremes]).astype(np.float32)))
    feats = [np.stack([im[0][i] for im in images]) for i in range(len(SIZES))]
    return feats, np.stack([im[1] for im in images])


def _nchw(feats_nhwc, dtype=torch.float32):
    return [torch.tensor(f).permute(0, 3, 1, 2).contiguous().to(dtype) for f in feats_nhwc]


def _slots(feats_nhwc, rois, dtype=torch.float32):
    out = pra.multiscale_roi_align_slots(_nchw(feats_nhwc, dtype), torch.tensor(rois))
    assert out.dtype == dtype and out.shape == (*rois.shape[:2], feats_nhwc[0].shape[-1], 7, 7)
    return out.float().permute(0, 1, 3, 4, 2).numpy()  # -> [B, n, 7, 7, C]


def test_plain_matches_jax_pallas_kernel(fuzz):
    feats, rois = fuzz
    got = _slots(feats, rois)
    for i in range(rois.shape[0]):
        want = np.asarray(
            multiscale_roi_align_pallas(
                tuple(jnp.asarray(f[i]) for f in feats), jnp.asarray(rois[i]), interpret=True
            )
        )
        err = np.abs(got[i] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (i, err, np.abs(want).max())


def test_plain_matches_the_forwards_plain_version(fuzz):
    feats, rois = fuzz
    r = torch.tensor(rois)
    level = pra.fpn_level_assignment(r)
    got = pra.multiscale_roi_align_slots_reference(_nchw(feats), r, level)
    want = pra.multiscale_roi_align_reference(_nchw(feats), r, level)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_bfloat16_within_one_ulp_of_float32(fuzz):
    feats, rois = fuzz
    feats = [torch.tensor(f).to(torch.bfloat16).float().numpy() for f in feats]
    got = _slots(feats, rois, torch.bfloat16)
    exact = _slots(feats, rois)
    mag = np.maximum(np.abs(exact), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)  # bfloat16 keeps 8 significant bits
    assert (np.abs(got - exact) <= ulp).all()


def test_dispatch_and_small_levels(fuzz):
    feats_nhwc, rois = fuzz
    feats = _nchw(feats_nhwc)
    r = torch.tensor(rois)
    level = pra.fpn_level_assignment(r)
    before = pra.multiscale_roi_align_slots_cuda.launches
    out = pra.multiscale_roi_align_slots(feats, r)
    assert torch.equal(out, pra.multiscale_roi_align_slots_reference(feats, r, level))
    assert pra.multiscale_roi_align_slots_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pra.multiscale_roi_align_slots_cuda(feats, r, level)  # no silent CPU path
    with pytest.raises(ValueError, match="2x2"):
        pra.multiscale_roi_align_slots([*feats[:3], feats[3][:, :, :1]], r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_bit_for_bit(fuzz, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    feats_nhwc, rois = fuzz
    feats = [f.to("cuda") for f in _nchw(feats_nhwc, dtype)]
    r = torch.tensor(rois).cuda()
    before = pra.multiscale_roi_align_slots_cuda.launches
    out = pra.multiscale_roi_align_slots(feats, r)
    torch.cuda.synchronize()
    assert pra.multiscale_roi_align_slots_cuda.launches == before + 1
    want = pra.multiscale_roi_align_slots_reference(feats, r, pra.fpn_level_assignment(r))
    assert out.dtype == dtype and torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_footprint_edges(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    canvas = (384, 448)
    gen = torch.Generator().manual_seed(5)
    feats = [torch.randn(2, 32, h, w, generator=gen).to("cuda", dtype) for h, w in chip_smoke._align_level_shapes(canvas)]
    r = chip_smoke.footprint_rois(gen, 96, canvas).cuda()
    level = pra.fpn_level_assignment(r)
    out = pra.multiscale_roi_align_slots_cuda(feats, r, level)
    torch.cuda.synchronize()
    assert torch.equal(out, pra.multiscale_roi_align_slots_reference(feats, r, level))

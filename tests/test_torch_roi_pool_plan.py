"""The RoIPool kernels' launch plans and the tie rule their scans rely on.

The CUDA kernels run only on the card; what surrounds them runs here.
``forward_plan`` and ``backward_plan`` cut the work into thread blocks:
every (image, channel, row, roi) must fall in exactly one block, and no
block may ask for more than an H100 block's 232,448 bytes of shared
memory, nor for less than its kernel lays out. The forward kernel gives a
tied bin the first max of its row-major scan; the plain version
(``roi_pool_reference``) must agree with "the smallest ``row * w + col``
among the bin's maxima", here computed by an independent numpy loop on
inputs with many plateaus.
"""

import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as prp
from tests.test_roi_ops import rand_rois

# (batch, channels, height, width, rois per image): the legacy 800x1344
# canvas at stride 16 in predict (300 rois) and in train and dense-scene
# train (2 images of 128 rois), two maps whose channel plane exceeds a
# block's shared memory, and small odd shapes.
SHAPES = {
    "predict": (1, 512, 50, 84, 300),
    "train": (2, 512, 50, 84, 128),
    "dense-train": (2, 512, 50, 84, 128),
    "large-f32": (1, 16, 240, 256, 64),
    "large-bf16": (1, 16, 340, 352, 64),
    "odd": (3, 5, 9, 11, 37),
    "one-roi": (2, 3, 7, 300, 1),
    "no-rois": (2, 3, 9, 11, 0),
}
DTYPES = {"float32": 4, "bfloat16": 2}
POOLED = 7


def _plans(shape, itemsize):
    b, c, h, w, n = shape
    return (
        prp.forward_plan(b, c, h, w, n, itemsize, POOLED, sms=132),
        prp.backward_plan(b, c, h, w, n),
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SHAPES)
def test_plans_cover_every_image_channel_row_roi_once(name, dtype):
    b, c, h, w, n = SHAPES[name]
    for plan in _plans(SHAPES[name], DTYPES[dtype]):
        hits = np.zeros((b, c, h, n), np.int32)
        blocks = list(plan.blocks())
        for image, (c_lo, c_hi), (y_lo, y_hi), (r_lo, r_hi) in blocks:
            assert c_lo < c_hi and y_lo < y_hi and r_lo <= r_hi
            hits[image, c_lo:c_hi, y_lo:y_hi, r_lo:r_hi] += 1
        assert (hits == 1).all(), f"{plan}: {np.unique(hits)}"
        assert len(blocks) == plan.grid


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SHAPES)
def test_plans_fit_shared_memory(name, dtype):
    b, c, h, w, n = SHAPES[name]
    itemsize = DTYPES[dtype]
    fwd, bwd = _plans(SHAPES[name], itemsize)
    assert 0 <= fwd.shared_bytes <= prp.SHARED_MEMORY_BYTES == 232_448
    plane = -(-h * w * itemsize // 16) * 16
    roi_bytes = 2 * POOLED * 4  # the packed bounds of a roi's bins
    if fwd.shared_bytes:  # staged: whole planes, then the rois' words
        assert fwd.band_rows == h
        assert fwd.shared_bytes >= -(-fwd.chunk_channels * h * w * itemsize // 16) * 16 + (
            fwd.chunk_rois * roi_bytes
        )
    else:  # the direct-read route: one plane and one roi do not fit
        assert plane + roi_bytes > prp.SHARED_MEMORY_BYTES
    assert bwd.chunk_rois >= n and bwd.shared_bytes <= prp.SHARED_MEMORY_BYTES
    assert bwd.shared_bytes >= bwd.chunk_channels * min(bwd.band_rows, h) * w * 4
    assert bwd.chunk_channels == 1
    if h * w * 4 > prp.SHARED_MEMORY_BYTES:  # bands
        assert bwd.band_rows < h
    else:
        assert bwd.band_rows == h


def test_large_planes_take_the_band_and_direct_routes():
    f32 = _plans(SHAPES["large-f32"], 4)
    bf16 = _plans(SHAPES["large-bf16"], 2)
    assert f32[0].shared_bytes == 0 and bf16[0].shared_bytes == 0
    assert (f32[1].band_rows, bf16[1].band_rows) == (120, 114)  # 2 and 3 even bands
    # The float32 map's plane fits in bfloat16: a staged block above 48 KB.
    assert _plans(SHAPES["large-f32"], 2)[0].shared_bytes > 48 * 1024


def test_predict_and_train_plans_fill_the_card():
    # The forward runs in predict and train, the backward in train only.
    for plan in (*_plans(SHAPES["train"], 4), _plans(SHAPES["predict"], 4)[0]):
        assert plan.grid >= 4 * 132 and plan.shared_bytes > 0


def test_backward_plan_refuses_a_row_wider_than_shared_memory():
    with pytest.raises(ValueError, match="row"):
        prp.backward_plan(1, 1, 2, 60_000, 3)


def _first_max_oracle(feat, rois, scale, pooled):
    """Per roi, channel and bin: the bin's max and the smallest
    ``row * w + col`` holding it, by loops over numpy arrays."""
    b, c, h, w = feat.shape
    n = rois.shape[1]
    values = np.zeros((b, n, c, pooled, pooled), np.float32)
    argmax = np.full((b, n, c, pooled, pooled), -1, np.int64)
    for i in range(b):
        for r in range(n):
            corners = np.rint(rois[i, r] * np.float32(scale)).astype(np.int64)  # half to even
            x0, y0, x1, y1 = (int(v) for v in corners)
            ext_h, ext_w = max(y1 - y0 + 1, 1), max(x1 - x0 + 1, 1)
            for ph in range(pooled):
                hs = min(max(y0 + ph * ext_h // pooled, 0), h)
                he = min(max(y0 + -(-(ph + 1) * ext_h // pooled), 0), h)
                for pw in range(pooled):
                    ws = min(max(x0 + pw * ext_w // pooled, 0), w)
                    we = min(max(x0 + -(-(pw + 1) * ext_w // pooled), 0), w)
                    if he <= hs or we <= ws:
                        continue
                    window = feat[i, :, hs:he, ws:we].reshape(c, -1)
                    best = window.max(axis=1)
                    rows, cols = np.meshgrid(np.arange(hs, he), np.arange(ws, we), indexing="ij")
                    pos = (rows * w + cols).reshape(-1)
                    tied = np.where(window == best[:, None], pos[None, :], h * w)
                    values[i, r, :, ph, pw] = best
                    argmax[i, r, :, ph, pw] = tied.min(axis=1)
    return values, argmax


@pytest.mark.parametrize("scale", [1.0, 1.0 / 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_argmax_is_the_smallest_position_among_the_maxima(dtype, scale):
    rs = np.random.RandomState(17)
    b, c, h, w, n = 2, 4, 15, 19, 21
    feat = rs.randint(0, 3, size=(b, c, h, w)).astype(np.float32)  # plateaus everywhere
    feat[:, :, 4:9, 2:12] = 2.0  # and a wide one at the top value
    feat[0, 1] = 1.0  # a constant channel: every bin ties throughout
    rois = np.stack([rand_rois(rs, n, h, w) for _ in range(b)])
    rois[:, :5] = [
        [0, 0, w, h],  # the whole map (extent = size + 1)
        [2.5, 1.5, 5.5, 4.5],  # .5 corners: half to even
        [3, 5, 3.2, 5.2],  # one cell
        [-4, -3, w + 6, h + 9],  # beyond the map: empty bins
        [w - 0.5, h - 0.5, w, h],  # the far corner
    ]
    rois = (rois / scale).astype(np.float32)
    want, want_arg = _first_max_oracle(feat, rois, scale, POOLED)
    got, got_arg = prp.roi_pool_reference(
        torch.tensor(feat).to(dtype), torch.tensor(rois), scale, POOLED, with_argmax=True
    )
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got_arg.numpy(), want_arg)
    assert (want_arg == -1).any() and (want_arg >= 0).any()

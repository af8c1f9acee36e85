"""The segmented NMS (``ops/nms.py::nms_segments*``, ``frcnn::nms_segments``)
and the sync-free ``nms`` / ``batched_nms`` / ``multiclass_nms`` against
the JAX package's fixed-shape NMS, and the ``torch.library`` ops' fake
implementations against their real ones.

Same inputs into both sides give identical keep positions, counts, valid
flags and labels; kept boxes and scores are gathered copies of the inputs,
so they agree exactly too (atol 1e-6 as ``tests/test_torch_nms.py``
states it). The plain version is held against the JAX ``nms`` up to the
kernel's depths too: thousands of boxes in many tiles, ``post_k`` cut
inside a tile of the kernel, and pairs whose IoU lies within 2 ulps of the
threshold. The kernel's launch plan (``nms_plan``: the cluster width at
each call site and the shared memory a CTA takes) is checked here; the
CUDA case (the kernel against the plain version at every call site and
width, bit for bit) skips without a card.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from faster_rcnn_pytorch_tpu_torch.ops import library  # noqa: F401
from faster_rcnn_pytorch_tpu_torch.ops import nms as pnms
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra
from tests.conftest import boxes_fixture

# ops/__init__ re-exports the function `nms`, which shadows the module
jnms = importlib.import_module("faster_rcnn_pytorch_tpu.ops.nms")

ATOL = 1e-6
NMS_SITES = smoke.NMS_SITES


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def hard_segments(rs, s, n, scale=1.0):
    """``s`` score-sorted segments of ``n`` boxes: RPN-like clumps around a
    few centres, exact duplicates, tied scores, degenerate and zero-area
    boxes, and an invalid tail (plus scattered invalid entries)."""
    boxes = np.zeros((s, n, 4), np.float32)
    valid = np.zeros((s, n), bool)
    for i in range(s):
        centres = rs.uniform(0.2, 0.8, size=(4, 2)) * scale
        c = centres[rs.randint(0, 4, size=n)] + rs.normal(0, 0.03 * scale, size=(n, 2))
        wh = rs.uniform(0.05, 0.3, size=(n, 2)) * scale
        b = np.concatenate([c - wh / 2, c + wh / 2], 1)
        b[::7] = boxes_fixture(rs, len(b[::7]), scale)  # scattered ones
        b[5::11] = b[4::11][: len(b[5::11])]  # exact duplicates of a neighbour
        b[3::13, 2:] = b[3::13, :2]  # degenerate: zero area
        b[9::17, 2] = b[9::17, 0]  # zero width only
        b[0] = b[1]  # a tie at the very start
        boxes[i] = b
        tail = n - rs.randint(0, n // 4 + 1)
        valid[i, :tail] = rs.uniform(size=tail) > 0.1
    return boxes, valid


def jax_segment(boxes, valid, thr, post_k):
    """JAX ``nms`` over one sorted segment -> (positions, count)."""
    n = boxes.shape[0]
    scores = np.linspace(1.0, 0.0, n, dtype=np.float32)  # sorted; ignored under assume_sorted
    idx, ok = jnms.nms(
        _j(boxes), _j(scores), thr, post_k=post_k, valid=_j(valid), tile=64, assume_sorted=True
    )
    return np.asarray(idx), int(np.asarray(ok).sum())


def _iou32(a, b):
    """``box_iou``'s float32 arithmetic, in its order: ``a [4]`` against
    ``b [m, 4]``."""
    w = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), np.float32(0))
    h = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), np.float32(0))
    inter = w * h
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = np.maximum((a[2] - a[0]) * (a[3] - a[1]) + area_b - inter, np.float32(1e-12))
    return inter / union


def threshold_segments(rs, s, n, thr):
    """``s`` segments of ``n // 2`` isolated pairs (one box and a copy
    shifted along x), each pair's float32 IoU 2 ulps below to 2 ulps above
    float32(``thr``), exactly on it where the float grid allows: the later
    box is kept iff its IoU does not exceed the threshold. The first half
    of the pairs sit side by side; in the second half all first boxes come
    before all partners, so each partner meets its box across tiles."""
    t = np.float32(thr)
    boxes = np.zeros((s, n, 4), np.float32)
    for i in range(s):
        pairs = []
        side = int(np.ceil(np.sqrt(n // 2)))
        for j in range(n // 2):
            origin = np.float32(0.5) * np.array(divmod(j, side), np.float32)
            near = []
            while not len(near):  # far from 0 the float grid may miss the band: draw again
                xy = origin + rs.uniform(0, 0.05, 2).astype(np.float32)
                a = np.concatenate([xy, xy + rs.uniform(0.05, 0.1, 2).astype(np.float32)])
                dx = np.float32((a[2] - a[0]) * (1 - thr) / (1 + thr))
                d = (dx.view(np.int32) + np.arange(-4096, 4096, dtype=np.int32)).view(np.float32)
                b = np.stack([a[0] + d, np.full_like(d, a[1]), a[2] + d, np.full_like(d, a[3])], 1)
                ulps = _iou32(a, b).view(np.int32) - t.view(np.int32)
                near = np.flatnonzero(np.abs(ulps) <= 2)
            pairs.append((a, b[near[rs.randint(len(near))]]))
        half = len(pairs) // 2
        order = [x for a, b in pairs[:half] for x in (a, b)]
        order += [a for a, _ in pairs[half:]] + [b for _, b in pairs[half:]]
        boxes[i, : len(order)] = order
    valid = np.zeros((s, n), bool)
    valid[:, : 2 * (n // 2)] = True
    return boxes, valid


SEGMENTS = {"hard": hard_segments, "threshold": threshold_segments}

# (data, segments, n, threshold, post_k, the plain sweep's tile, whether post_k
# must cut the greedy inside a tile of the kernel's 64 boxes)
REFERENCE_CASES = [
    ("hard", 3, 300, 0.7, 300, 64, False),  # proposals: keep everything that survives
    ("hard", 4, 257, 0.3, 40, 128, False),  # post_k cuts the greedy short
    ("hard", 2, 130, 0.5, 200, 32, False),  # post_k beyond n
    ("hard", 5, 64, 0.0, 64, 256, False),  # any overlap suppresses
    # proposal depth: many tiles, kept lists in the hundreds
    ("hard", 1, 3000, 0.7, 2000, 256, False),
    ("hard", 2, 2500, 0.7, 1021, 512, True),
    ("hard", 2, 2000, 0.3, 201, 128, True),
    # IoUs within 2 ulps of the threshold, inside tiles and across them
    ("threshold", 1, 2000, 0.7, 2000, 256, False),
    ("threshold", 2, 1200, 0.3, 1200, 64, False),
]


def _case_id(data, s, n, thr, post_k, tile, mid):
    return f"{s}-{n}-{thr}-{post_k}-{tile}" + ("" if data == "hard" and n < 1000 else f"-{data}")


@pytest.mark.parametrize(
    "data,s,n,thr,post_k,tile,mid", REFERENCE_CASES, ids=[_case_id(*c) for c in REFERENCE_CASES]
)
def test_reference_equals_jax_segment_by_segment(data, s, n, thr, post_k, tile, mid):
    rs = np.random.RandomState(n + s)
    boxes, valid = SEGMENTS[data](rs, s, n) if data == "hard" else SEGMENTS[data](rs, s, n, thr)
    keep, count = pnms.nms_segments_reference(_t(boxes), _t(valid), thr, post_k, tile)
    assert keep.dtype == torch.int32 and keep.shape == (s, post_k)
    assert count.dtype == torch.int32 and count.shape == (s,)
    # On these boxes the JAX side runs op by op, as box_iou is written: XLA's
    # fused CPU program contracts an area product into the union's addition
    # (an FMA), which moves about 8% of these IoUs by an ulp or more.
    for i in range(s):
        with jax.disable_jit() if data == "threshold" else contextlib.nullcontext():
            want, want_count = jax_segment(boxes[i], valid[i], thr, post_k)
        np.testing.assert_array_equal(keep[i].numpy(), want, err_msg=f"segment {i}")
        assert int(count[i]) == want_count
    # the op gives the plain version on the CPU, and tile does not matter
    op_keep, op_count = pnms.nms_segments(_t(boxes), _t(valid), thr, post_k, tile=7)
    assert torch.equal(op_keep, keep) and torch.equal(op_count, count)
    if mid:  # the post_k-th kept box and the next survivor share a kernel tile
        full, _ = pnms.nms_segments_reference(_t(boxes), _t(valid), thr, n, tile)
        assert (count == post_k).all()
        tiles = full[:, post_k - 1 : post_k + 1] // pnms.KERNEL_TILE
        assert (tiles[:, 0] == tiles[:, 1]).all(), tiles
    if data == "threshold":  # isolated pairs: a partner is kept iff its IoU <= thr
        t = np.float32(thr)
        for i in range(s):
            want = [
                j < 2 * (n // 2) and not (_iou32(boxes[i, j], boxes[i, :j]) > t).any() for j in range(n)
            ]
            np.testing.assert_array_equal(np.isin(np.arange(n), keep[i, : int(count[i])]), want)
            assert 0 < int(count[i]) < n // 2 * 2


def test_all_invalid_and_empty_segments_keep_nothing():
    rs = np.random.RandomState(1)
    boxes, valid = hard_segments(rs, 3, 50)
    valid[1] = False
    keep, count = pnms.nms_segments_reference(_t(boxes), _t(valid), 0.5, 10)
    assert count[1] == 0 and (keep[1] == -1).all()
    assert count[0] > 0 and count[2] > 0
    keep, count = pnms.nms_segments_reference(torch.zeros(2, 0, 4), torch.zeros(2, 0, dtype=torch.bool), 0.5, 4)
    assert keep.shape == (2, 4) and (keep == -1).all() and (count == 0).all()


@pytest.mark.parametrize("ties", [False, True])
def test_sync_free_nms_and_batched_nms_match_jax(ties):
    rs = np.random.RandomState(11 + ties)
    n = 400
    boxes, valid = hard_segments(rs, 1, n, scale=37.0)
    boxes, valid = boxes[0], valid[0]
    scores = rs.uniform(size=n).astype(np.float32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(np.float32)
    j = jnms.nms(_j(boxes), _j(scores), 0.5, post_k=150, valid=_j(valid), tile=64, return_boxes=True)
    p = pnms.nms(_t(boxes), _t(scores), 0.5, post_k=150, valid=_t(valid), tile=64, return_boxes=True)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(p[2].numpy(), np.asarray(j[2]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p[3].numpy(), np.asarray(j[3]), rtol=0, atol=ATOL)
    cls = rs.randint(0, 6, size=n).astype(np.int32)
    j = jnms.batched_nms(_j(boxes), _j(scores), _j(cls), 0.4, post_k=n, valid=_j(valid), tile=64)
    p = pnms.batched_nms(_t(boxes), _t(scores), _t(cls), 0.4, post_k=n, valid=_t(valid), tile=64)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))


def _head_outputs(rs, n, num_classes, scale_logits):
    rois = boxes_fixture(rs, n)
    jitter = rs.normal(scale=0.02, size=(n, num_classes, 4)).astype(np.float32)
    cls_boxes = np.clip(rois[:, None, :] + jitter, 0, 1)
    cls_boxes = np.concatenate(
        [np.minimum(cls_boxes[..., :2], cls_boxes[..., 2:]), np.maximum(cls_boxes[..., :2], cls_boxes[..., 2:])],
        -1,
    ).astype(np.float32)
    logits = np.round(rs.normal(scale=scale_logits, size=(n, num_classes)) * 4) / 4  # ties
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return cls_boxes, probs.astype(np.float32)


def _assert_matches_jax(p, j, i):
    j_boxes, j_labels, j_scores, j_valid = (np.asarray(x) for x in j)
    np.testing.assert_array_equal(p[3][i].numpy(), j_valid)
    np.testing.assert_array_equal(p[1][i].numpy(), j_labels)
    np.testing.assert_allclose(p[0][i].numpy(), j_boxes, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p[2][i].numpy(), j_scores, rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "regime,n,num_classes,thres,candidate_k,scales",
    [
        ("offset", 150, 21, 0.05, None, (3.0, 1.0)),
        ("compact and per-class", 200, 91, 0.05, 500, (1.0, 2.0)),
        ("compact only", 40, 91, 0.02, 40 * 90, (1.0, 2.0)),
        ("per-class, k_cand above n", 200, 91, 0.01, 512, (0.3, 0.2)),
    ],
)
def test_multiclass_nms_batch_matches_jax_per_image(regime, n, num_classes, thres, candidate_k, scales):
    """A batch of images, each held against the JAX package's
    ``multiclass_nms`` of that image; in the mixed case one image takes the
    compact pass and the other the per-class pass, in one launch."""
    rs = np.random.RandomState(n + num_classes)
    heads = [_head_outputs(rs, n, num_classes, s) for s in scales]
    cls_boxes = np.stack([h[0] for h in heads])
    probs = np.stack([h[1] for h in heads])
    n_valid = (probs[:, :, 1:] > thres).sum(axis=(1, 2))
    k = candidate_k or max(512, 200)
    if regime == "offset":
        assert (num_classes - 1) * n <= 16384
    elif regime == "compact and per-class":
        assert n_valid[0] <= k < n_valid[1], n_valid
    elif regime == "compact only":
        assert k == (num_classes - 1) * n
    else:
        assert (n_valid > k).all() and k > n, n_valid
    kw = dict(num_classes=num_classes, per_class_k=60, max_det=100, tile=128, candidate_k=candidate_k)
    p = pnms.multiclass_nms_batch(_t(cls_boxes), _t(probs), thres, 0.3, **kw)
    assert p[0].shape == (2, 100, 4) and p[1].dtype == torch.int32
    for i in range(2):
        j = jnms.multiclass_nms(_j(cls_boxes[i]), _j(probs[i]), thres, 0.3, **kw)
        _assert_matches_jax(p, j, i)
        assert np.asarray(j[3]).sum() > 0


def _opcheck(op, args):
    # test_aot_dispatch_dynamic needs a compiler toolchain this host may not
    # have; the schema, the fake implementation and the autograd
    # registration are what an exported program relies on.
    torch.library.opcheck(
        op, args, test_utils=("test_schema", "test_autograd_registration", "test_faketensor")
    )


def test_ops_fake_implementations_match_real_shapes_and_dtypes():
    rs = np.random.RandomState(5)
    boxes, valid = hard_segments(rs, 3, 90)
    nms_args = (_t(boxes), _t(valid), 0.5, 20, 32, False)
    _opcheck(torch.ops.frcnn.nms_segments.default, nms_args)

    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.tensor(rs.normal(size=(2, 3, 9, 11)).astype(np.float32)).to(dtype)
        rois = torch.tensor(np.stack([boxes_fixture(rs, 5, 10.0) for _ in range(2)]))
        _opcheck(torch.ops.frcnn.roi_pool.default, (feats, rois, 1.0, 7, False))
        levels = [
            torch.tensor(rs.normal(size=(2, 4, 64 // s, 96 // s)).astype(np.float32)).to(dtype)
            for s in pra.STRIDES
        ]
        px = torch.tensor(np.stack([boxes_fixture(rs, 6, 64.0) for _ in range(2)]))
        level = pra.fpn_level_assignment(px)
        _opcheck(torch.ops.frcnn.multiscale_roi_align.default, (levels, px, level, False))

    # the fakes alone: shapes and dtypes without running anything
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fb = mode.from_tensor(_t(boxes))
        fv = mode.from_tensor(_t(valid))
        keep, count = torch.ops.frcnn.nms_segments(fb, fv, 0.5, 20, 32, False)
    assert keep.shape == (3, 20) and keep.dtype == torch.int32
    assert count.shape == (3,) and count.dtype == torch.int32


# The cluster width of every call site (chip_smoke.NMS_SITES) on an H100's
# 132 SMs: where the card runs 21 clusters of 16 CTAs at once (an H100 80GB
# HBM3 at these shares), and where it runs none.
SITE_WIDTHS = {
    "proposals, legacy predict": (8, 8),  # 300 kept: a share of 19 at 16 is under MIN_SHARE
    "proposals, legacy train": (16, 8),
    "proposals, FPN predict": (16, 8),
    "proposals, FPN train": (16, 8),
    "per-class, legacy (offset pass)": (1, 1),  # 100 kept
    "per-class, FPN (compact + 90 classes)": (1, 1),  # 182 segments fill the card
}


@pytest.mark.parametrize("site", NMS_SITES, ids=[row[0] for row in NMS_SITES])
def test_cluster_plan_at_every_call_site(site):
    """``nms_plan`` at each call site: the width, a share that holds
    ``post_k`` kept boxes spread ``k mod W`` over the CTAs, and a CTA's
    shared memory under an H100 block's 232,448 bytes."""
    what, s, _, post_k, _, _ = site
    wide, portable = SITE_WIDTHS[what]
    for clusters, want in ((21, wide), (0, portable), (s, wide), (s - 1, portable)):
        plan = pnms.nms_plan(s, post_k, sms=132, wide_clusters=clusters)
        assert plan.width == want, (clusters, plan)
        assert s * plan.width <= 132 or plan.width == 1
        assert plan.share == -(-post_k // plan.width)
        k = np.arange(post_k)
        assert (k // plan.width < plan.share).all()  # CTA k % W's slot k // W
        assert plan.shared_bytes == pnms.nms_shared_bytes(plan.share)
        assert plan.shared_bytes + pnms.STATIC_SHARED_BYTES <= pnms.SHARED_MEMORY_BYTES == 232_448


@pytest.mark.parametrize(
    "segments,post_k,clusters,width",
    [
        (16, 2000, 21, 8),  # 16 x 16 CTAs exceed 132 SMs; 16 x 8 do not
        (17, 2000, 21, 1),  # 17 x 8 exceed them too
        (1, 511, 21, 8),  # a 16-wide share of 32 needs post_k 512
        (1, 512, 21, 16),
        (1, 255, 21, 1),  # an 8-wide share of 32 needs 256
        (3, 4000, 2, 8),  # 16-wide clusters, but not 3 of them at once
        (1, 11000, 0, 8),
        (200, 11000, 0, 1),  # 220 KB of shared memory a CTA: still fits
        (0, 100, 0, 1),
    ],
)
def test_cluster_plan_rules(segments, post_k, clusters, width):
    plan = pnms.nms_plan(segments, post_k, sms=132, wide_clusters=clusters)
    assert plan.width == width
    assert plan.shared_bytes + pnms.STATIC_SHARED_BYTES <= pnms.SHARED_MEMORY_BYTES


def test_cluster_plan_refuses_a_share_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        pnms.nms_plan(200, 12000, sms=132)  # W = 1: 240 KB a CTA
    assert pnms.nms_plan(2, 12000, sms=132).width == 8  # the same list over 8 CTAs fits


def test_cuda_kernel_matches_reference_at_call_site_shapes():
    """The kernel against the plain sweep at every call site, at the planned
    width and at 1, 8 and 16 CTAs a segment, and on near-threshold pairs at
    W > 1: keep and counts identical, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda", 0)
    cases = [
        (what, smoke.nms_segments_inputs(smoke.SEED + 20 + i, s, n, smoke.NUM_CLASSES - 1 if "offset" in what else 0,
                                         "compact" in what), thr, post_k)
        for i, (what, s, n, post_k, thr, _) in enumerate(NMS_SITES)
    ]
    rs = np.random.RandomState(3)
    cases.append(("near-threshold pairs", threshold_segments(rs, 2, 2000, 0.7), 0.7, 1000))
    for what, (boxes, valid), thr, post_k in cases:
        tb, tv = _t(boxes).to(dev), _t(valid).to(dev)
        want_keep, want_count = pnms.nms_segments(tb, tv, thr, post_k, plain=True)
        for width in (None, 1, 8, 16):
            before = pnms.nms_segments_cuda.launches
            if width is None:
                keep, count = pnms.nms_segments(tb, tv, thr, post_k)
            else:
                keep, count = pnms.nms_segments_cuda(tb, tv, thr, post_k, width=width)
            torch.cuda.synchronize()
            assert pnms.nms_segments_cuda.launches == before + 1
            assert torch.equal(keep, want_keep) and torch.equal(count, want_count), (what, width)

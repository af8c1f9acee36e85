"""The RPN's anchor assignment for a batch, without the ``[G, A]`` IoU.

``rpn_targets`` reads three things of each image's gt-major masked IoU:
every anchor's max and first argmax over gt, and the "allow low-quality
matches" set built from each gt's max over anchors. The port computes them
for the whole batch in one step (``ops/boxes.py::rpn_match``; on a card
``ops/cuda/anchor_match.cu``, one call), and ``train_targets`` runs it once
a step before the batch's labels (``models/targets.py::rpn_labels``).
Held here:

* the plain match (``rpn_match_reference``, the kernel's twin) against the
  JAX package's chain, op by op on the CPU: ``masked_iou_gt_major``,
  ``where(inside)``, ``max`` / ``argmax`` over each axis, then the tie set
  (``allow_ties``, FPN) or the ``.at[argmax].max`` scatter (legacy), in
  both modes, for 1, 7 and 24 gt slots on the port's legacy and FPN
  anchors at small canvases, on a batch that holds duplicated gt slots,
  gt boxes equal to anchors, zero-area gt (its max is 0: every inside
  anchor ties), padded slots, an image with every slot padded and an image
  with every anchor outside: the maxima bit for bit, the indices and the
  sets equal;
* ``train_targets`` (both generations' configs; a batch of 3 with 0, 5
  and 11 real gt of 12 slots, and a crowded one: an image whose positives
  exceed each quota, one without gt, one whose candidates cannot fill the
  RoI budget) calls the match once for the batch and gives, bit for bit,
  the targets of per-image ``rpn_targets`` and ``frcnn_targets``;
* the cases aimed at the kernel's culling and gt split (``crafted``): a
  gt whose only non-zero IoUs lie in one tile, gt that meet no inside
  anchor (max 0), inverted and zero-area gt at eps 1e-5 and 0, more slots
  than the kernel stages at a time and not a multiple of the plan's split,
  an anchor count that is not a multiple of the tile: the plain match
  against the JAX chain in both modes;
* ``rpn_match_plan`` at the main path's six shapes (FPN and legacy at
  800x1344 with 640 / 512 and 100 slots, both at 320x512, batch 8, 100
  slots): its block counts and layout, shares that cover every slot once,
  tiles that cover every anchor;
* ``rpn_match_cuda`` refuses CPU tensors, and ``rpn_match`` any device
  without a kernel;
* on a card only (skipped here): the kernel equals its twin bit for bit at
  the dense FPN and legacy shapes and on the crafted cases at 800x1344, in
  both modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.ops import boxes as jb
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models.anchors import fpn_anchors, legacy_anchors
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import FPN_CONFIG, LEGACY_CONFIG
from faster_rcnn_pytorch_tpu_torch.ops import boxes as pb
from tests.conftest import boxes_fixture
from tests.torch_train_batches import assert_equal_targets, per_image_targets, train_batch

ANCHORS = {
    "legacy": lambda: legacy_anchors(160, 224),  # 1260 anchors
    "fpn": lambda: fpn_anchors(64, 96),  # 1536 anchors over P2..P6
}


def match_batch(seed, anchors, slots):
    """Four images against ``anchors``: (0) gt from the fixture, with slot
    0 copied into the last real slot, slot 1 an anchor's own box, slot 2 of
    zero area, the rest of the slots padded; (1) every slot padded; (2)
    image 0's gt with every anchor outside; (3) image 0's gt with the
    anchors inside a cropped extent (the legacy boundary filter)."""
    rs = np.random.RandomState(seed)
    real = max(1, slots - slots // 4)
    gt = np.zeros((4, slots, 4), np.float32)
    gt[0, :real] = boxes_fixture(rs, real)
    if slots > 2:
        gt[0, 1] = anchors[rs.randint(len(anchors))]
        gt[0, 2, 2] = gt[0, 2, 0]
        gt[0, real - 1] = gt[0, 0]
    gt[2:] = gt[0]
    gt_mask = np.zeros((4, slots), bool)
    gt_mask[[0, 2, 3], :real] = True
    inside = np.ones((4, len(anchors)), bool)
    inside[2] = False
    inside[3] = (anchors[:, :2] >= 0).all(1) & (anchors[:, 2] <= 0.85) & (anchors[:, 3] <= 0.7)
    return gt, gt_mask, inside


def jax_chain(anchors, gt, gt_mask, inside, allow_ties):
    """``faster_rcnn_pytorch_tpu/models/targets.py::rpn_targets``' match,
    for one image."""
    iou = jb.masked_iou_gt_major(jnp.asarray(gt), jnp.asarray(gt_mask), jnp.asarray(anchors))
    iou = jnp.where(jnp.asarray(inside)[None, :], iou, -1.0)
    per_gt_max = iou.max(axis=1)
    real = jnp.asarray(gt_mask) & (per_gt_max > -1.0)
    if allow_ties:
        best_any = ((iou == per_gt_max[:, None]) & real[:, None]).any(axis=0)
    else:
        best_any = jnp.zeros((anchors.shape[0],), jnp.int32).at[iou.argmax(axis=1)].max(
            real.astype(jnp.int32)
        ) > 0
    return (np.asarray(iou.max(axis=0)), np.asarray(iou.argmax(axis=0)), np.asarray(best_any),
            np.asarray(iou), np.asarray(per_gt_max), np.asarray(real))


@pytest.mark.parametrize("allow_ties", [True, False], ids=["ties", "argmax"])
@pytest.mark.parametrize("generation", ["legacy", "fpn"])
@pytest.mark.parametrize("slots", [1, 7, 24])
def test_plain_match_matches_the_jax_chain(slots, generation, allow_ties):
    anchors = ANCHORS[generation]()
    gt, gt_mask, inside = match_batch(slots, anchors, slots)
    got = pb.rpn_match(*(torch.tensor(x) for x in (anchors, gt, gt_mask, inside)), allow_ties)
    assert [t.dtype for t in got] == [torch.float32, torch.int64, torch.bool]
    assert all(t.shape == (4, len(anchors)) for t in got)
    for i in range(4):
        want_max, want_arg, want_any, iou, per_gt_max, real = jax_chain(
            anchors, gt[i], gt_mask[i], inside[i], allow_ties
        )
        np.testing.assert_array_equal(got[0][i].numpy().view(np.int32), want_max.view(np.int32))
        np.testing.assert_array_equal(got[1][i].numpy(), want_arg)
        np.testing.assert_array_equal(got[2][i].numpy(), want_any)
        if i == 0:  # the inputs reach the cases the kernel's reductions must get right
            assert real.any() and want_any.any()
            if slots > 2:
                assert per_gt_max[1] > 0.99 and per_gt_max[2] == 0.0  # area / (area + eps)
                n_tied = int(((iou == per_gt_max[:, None]) & real[:, None]).any(0).sum())
                if allow_ties:  # the zero-area gt ties every anchor
                    assert want_any.sum() == n_tied == inside[i].sum() > real.sum()
        elif i in (1, 2):  # nothing real: every column -1 at slot 0, no best anchor
            assert (want_max == -1).all() and (want_arg == 0).all() and not want_any.any()
        else:
            assert not want_any[~inside[i]].any() and (want_max[~inside[i]] == -1).all()


# train_targets' batches: (canvas of each generation, gt slots, real gt an
# image, extents, seed, gt scale). "ragged": 0, 5 and 11 real gt of 12
# slots; "crowded": an image whose positives exceed the RPN's and the
# RoI head's positive quotas, one without gt, and one whose extent leaves
# too few candidates to fill the RoI budget.
TRAIN_SCENES = {
    "ragged": ({"legacy": (160, 224), "fpn": (64, 96)}, 12, (0, 5, 11),
               [[1.0, 1.0], [0.8, 0.9], [0.7, 1.0]], 5, 0.7),
    "crowded": ({"legacy": (480, 640), "fpn": (64, 96)}, 200, (200, 0, 3),
                [[1.0, 1.0], [0.2, 0.2], [0.05, 0.08]], 6, 1.0),
}


@pytest.mark.parametrize("scene", list(TRAIN_SCENES))
@pytest.mark.parametrize("cfg", [LEGACY_CONFIG, FPN_CONFIG], ids=["legacy", "fpn"])
def test_train_targets_match_once_for_the_batch_as_rpn_targets_per_image(cfg, scene, monkeypatch):
    canvas, slots, reals, extents, seed, scale = TRAIN_SCENES[scene]
    generation = "fpn" if cfg.rpn_allow_ties else "legacy"
    anchors = torch.tensor((fpn_anchors if cfg.rpn_allow_ties else legacy_anchors)(*canvas[generation]))
    batch = train_batch(cfg, anchors, slots, reals, extents, seed, scale)
    b = len(reals)

    calls = []
    match = pb.rpn_match_reference

    def spy(anchors, gt, *args, **kwargs):
        calls.append(tuple(gt.shape))
        return match(anchors, gt, *args, **kwargs)

    monkeypatch.setattr(pb, "rpn_match_reference", spy)
    stages = {}
    rpn_tg, roi_tg = pfr.train_targets(
        cfg, anchors, *batch, on_stage=lambda name, result: stages.__setitem__(name, result)
    )
    assert calls == [(b, slots, 4)]
    assert tuple(stages) == pfr.TRAIN_TARGET_STAGES
    assert int((rpn_tg.labels == 1).sum()) > 0
    if scene == "crowded":  # each quota binds in image 0; image 2 leaves slots invalid
        assert int(stages["rpn_match"][0].sum()) > cfg.rpn_pos_quota
        assert int((rpn_tg.labels[0] == 1).sum()) == cfg.rpn_pos_quota
        assert int((stages["roi_match"][0] >= cfg.roi_pos_iou).sum()) > cfg.roi_pos_quota
        assert int(roi_tg.is_pos[0].sum()) == cfg.roi_pos_quota
        assert not roi_tg.valid[1].any() and not roi_tg.valid[2].all()
    for i, (want_rpn, want_roi) in enumerate(per_image_targets(cfg, anchors, batch)):
        assert_equal_targets(rpn_tg, want_rpn, i)
        assert_equal_targets(roi_tg, want_roi, i)
    assert len(calls) == 1 + b  # one for the batch, then one per image for rpn_targets


def test_cuda_wrapper_refuses_cpu_tensors():
    anchors = ANCHORS["legacy"]()
    args = [torch.tensor(x) for x in (anchors, *match_batch(0, anchors, 7))]
    with pytest.raises(ValueError, match="CUDA"):
        pb.rpn_match_cuda(*args, True)
    with pytest.raises(NotImplementedError):
        pb.rpn_match(*(t.to("meta") for t in args), True)


def _meets(box, anchors):
    iw = np.minimum(box[2], anchors[:, 2]) - np.maximum(box[0], anchors[:, 0])
    ih = np.minimum(box[3], anchors[:, 3]) - np.maximum(box[1], anchors[:, 1])
    return (iw > 0) & (ih > 0)


CRAFTED = ("one tile", "no inside anchor", "degenerate eps 1e-5", "degenerate eps 0", "long", "ragged")


def crafted(case, anchors, slots=12, long_slots=601):
    """Two images against ``anchors`` (the second with a cropped inside
    mask) for the cases the kernel culls or splits; returns ``(anchors, gt,
    gt_mask, inside, eps)``:

    * one tile: image 0 adds a tiny gt inside a mid-list anchor and sets
      outside every anchor it meets in another tile of ``RPN_MATCH_TILE``;
    * no inside anchor: a gt beyond the canvas (its max is 0) in image 0,
      one past the inside anchors' extent in image 1;
    * degenerate: slot 0 of a large negative area (its IoUs are -0),
      then gt inverted in x, in y and in both, of zero width, zero height
      and a point, at eps 1e-5 or 0;
    * long: ``long_slots`` slots, 90% real, past the kernel's chunk of 512
      and not a multiple of the plan's split;
    * ragged: the anchors cut to a count that is not a multiple of the
      tile."""
    rs = np.random.RandomState(CRAFTED.index(case))
    eps = 0.0 if case == "degenerate eps 0" else 1e-5
    n = long_slots if case == "long" else slots
    gt = np.zeros((2, n, 4), np.float32)
    gt_mask = np.zeros((2, n), bool)
    real = n - n // 10
    gt[:, :real] = boxes_fixture(rs, 2 * real).reshape(2, real, 4)
    gt_mask[:, :real] = True
    inside = np.ones((2, len(anchors)), bool)
    inside[1] = (anchors[:, :2] >= 0).all(1) & (anchors[:, 2] <= 0.8) & (anchors[:, 3] <= 0.9)
    if case == "one tile":
        a0 = len(anchors) // 2
        c = (anchors[a0, :2] + anchors[a0, 2:]) / 2
        gt[0, real - 1] = np.concatenate([c - 0.002, c + 0.002])
        tile = np.arange(len(anchors)) // pb.RPN_MATCH_TILE
        inside[0] &= ~(_meets(gt[0, real - 1], anchors) & (tile != a0 // pb.RPN_MATCH_TILE))
    elif case == "no inside anchor":
        gt[0, real - 1] = (10.0, 10.0, 10.1, 10.1)
        gt[1, real - 1] = (0.85, 0.1, 0.9, 0.2)
    elif case.startswith("degenerate"):
        gt[0, :7] = [[0.9, 0.1, 0.1, 0.9], [0.3, 0.2, 0.2, 0.4], [0.5, 0.3, 0.6, 0.2], [0.4, 0.4, 0.3, 0.3],
                     [0.2, 0.2, 0.2, 0.5], [0.6, 0.3, 0.8, 0.3], [0.7, 0.7, 0.7, 0.7]]
    elif case == "ragged":
        cut = len(anchors) - len(anchors) % pb.RPN_MATCH_TILE // 2 - 5
        anchors, inside = anchors[:cut], inside[:, :cut]
    return anchors, gt, gt_mask, inside, eps


@pytest.mark.parametrize("allow_ties", [True, False], ids=["ties", "argmax"])
@pytest.mark.parametrize("generation", ["legacy", "fpn"])
@pytest.mark.parametrize("case", CRAFTED)
def test_plain_match_matches_the_jax_chain_on_the_crafted_cases(case, generation, allow_ties):
    anchors, gt, gt_mask, inside, eps = crafted(case, ANCHORS[generation]())
    got = pb.rpn_match(*(torch.tensor(x) for x in (anchors, gt, gt_mask, inside)), allow_ties, eps)
    for i in range(2):
        iou = jb.masked_iou_gt_major(jnp.asarray(gt[i]), jnp.asarray(gt_mask[i]), jnp.asarray(anchors), eps)
        iou = np.asarray(jnp.where(jnp.asarray(inside[i])[None, :], iou, -1.0))
        per_gt_max = iou.max(axis=1)
        real = gt_mask[i] & (per_gt_max > -1.0)
        if allow_ties:
            want_any = ((iou == per_gt_max[:, None]) & real[:, None]).any(axis=0)
        else:
            want_any = np.zeros(len(anchors), bool)
            want_any[iou.argmax(axis=1)[real]] = True
        # Bit for bit, but for the sign of a zero max: torch.max keeps the first slot's bits (a
        # -0 from a negative union), the JAX chain's max gives +0 (the degenerate cases).
        want_max = iou.max(axis=0)
        signed = (want_max == 0) & (got[0][i].numpy().view(np.int32) == np.int32(-(2**31)))
        assert not signed.any() or case.startswith("degenerate")
        np.testing.assert_array_equal(got[0][i].numpy().view(np.int32)[~signed], want_max.view(np.int32)[~signed])
        np.testing.assert_array_equal(got[0][i].numpy(), want_max)
        np.testing.assert_array_equal(got[1][i].numpy(), iou.argmax(axis=0))
        np.testing.assert_array_equal(got[2][i].numpy(), want_any)
        if i == 0:  # the inputs reach the cases they are made for
            n_real = int(gt_mask[i].sum())
            if case == "one tile":
                tiles = np.unique(np.nonzero(iou[n_real - 1] > 0)[0] // pb.RPN_MATCH_TILE)
                assert len(tiles) == 1
            elif case == "no inside anchor":
                assert per_gt_max[n_real - 1] == 0.0 and real[n_real - 1]
                if allow_ties:
                    assert want_any[inside[i]].all()
            elif case.startswith("degenerate"):
                assert (iou[0][inside[i]].view(np.int32) == np.int32(-(2**31))).any()  # -0
                assert (got[0][i].numpy().view(np.int32) == np.int32(-(2**31))).any()
            elif case == "long":
                plan = pb.rpn_match_plan(len(anchors), gt.shape[1], 2)
                assert gt.shape[1] > 512 and gt.shape[1] % plan.split != 0
            elif case == "ragged":
                assert len(anchors) % pb.RPN_MATCH_TILE != 0


# (anchors, gt slots, images) of the six shapes the main path hands the kernel, and the plan's
# (tiles, split, share, pass-1 blocks, anchors a lane).
PLAN_SHAPES = {
    "fpn 640": ((268_569, 640, 2), (2099, 1, 640, 4198, 4)),
    "fpn 100": ((268_569, 100, 2), (2099, 1, 100, 4198, 1)),
    "legacy 512": ((37_800, 512, 2), (296, 7, 74, 4144, 4)),
    "legacy 100": ((37_800, 100, 2), (296, 1, 100, 592, 1)),
    "fpn 320x512": ((40_920, 100, 8), (320, 1, 100, 2560, 1)),
    "legacy 320x512": ((5_760, 100, 8), (45, 1, 100, 360, 1)),
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_rpn_match_plan_covers_every_anchor_and_slot_once(shape):
    (a, g, b), want = PLAN_SHAPES[shape]
    assert a == (len(fpn_anchors(800, 1344)) if shape == "fpn 640" else a)
    plan = pb.rpn_match_plan(a, g, b)
    assert (plan.tiles, plan.split, plan.share, plan.blocks, plan.per_lane) == want
    assert plan.tile == pb.RPN_MATCH_TILE and plan.second == plan.tiles * b
    covered = np.zeros(a, int)
    for t in range(plan.tiles):
        covered[t * plan.tile : (t + 1) * plan.tile] += 1
    assert (covered == 1).all() and (plan.tiles - 1) * plan.tile < a
    slots = np.zeros(g, int)
    for s in range(plan.split):
        lo = s * plan.share
        assert lo < g  # no empty share
        slots[lo : min(g, lo + plan.share)] += 1
    assert (slots == 1).all()
    assert plan.share >= min(g, pb.RPN_MATCH_MIN_SHARE)
    # few slots: one share, a lane an anchor; dense: the tiles alone come near the aim, or the
    # split brings pass 1 there without passing it
    dense = g >= pb.RPN_MATCH_DENSE_SLOTS
    aim = pb.RPN_MATCH_BLOCKS_PER_SM * 132
    assert dense or plan.split == 1
    assert not dense or plan.split == 1 and plan.tiles * b * 2 > aim or plan.blocks <= aim
    assert plan.per_lane == (4 if dense else 1)


@pytest.mark.parametrize("allow_ties", [True, False], ids=["ties", "argmax"])
def test_cuda_match_equals_its_twin(allow_ties):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    canvas = (800, 1344)
    anchors = fpn_anchors(*canvas) if allow_ties else legacy_anchors(*canvas)
    slots = 640 if allow_ties else 512
    batches = [(anchors, *match_batch(9, anchors, slots), 1e-5)]
    batches += [crafted(case, anchors, slots=100, long_slots=1100) for case in CRAFTED]
    for a, gt, gt_mask, inside, eps in batches:
        a, gt, gt_mask, inside = (torch.tensor(x).cuda() for x in (a, gt, gt_mask, inside))
        for ties in (allow_ties, not allow_ties):
            before = pb.rpn_match_cuda.launches
            got = pb.rpn_match(a, gt, gt_mask, inside, ties, eps)
            torch.cuda.synchronize()
            assert pb.rpn_match_cuda.launches == before + 1
            want = pb.rpn_match_reference(a, gt, gt_mask, inside, ties, eps)
            assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))

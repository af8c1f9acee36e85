"""``train_targets`` on the card: no device sync, and the batch's targets
equal the one-image entry points' (both need an NVIDIA GPU and nvcc, and
skip without one).

Both generations' budgets at 800x1344, a batch of 2 with images that
differ in gt count: legacy (argmax, the boundary filter, 100 gt slots:
the RoI match's plain chain under the IoU kernel's gate) and FPN (ties,
640 slots: the IoU kernel's match mode). The whole stage runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises on any op that
waits for the device. This file imports no JAX, so it also runs where
JAX is missing::

    python -m pytest --noconftest tests/test_torch_train_targets_sync.py -q
"""

import pytest
import torch

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models import targets as pt
from faster_rcnn_pytorch_tpu_torch.models.anchors import fpn_anchors, legacy_anchors

CANVAS = (800, 1344)
# (config, anchors, gt slots, real gt an image)
BUDGETS = {
    "legacy": (pfr.LEGACY_CONFIG, legacy_anchors, 100, (3, 42)),
    "fpn": (pfr.FPN_CONFIG, fpn_anchors, 640, (500, 0)),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _batch(generation, device, seed=0):
    """``train_targets``' arguments for a batch of 2 on ``device``."""
    cfg, make_anchors, slots, reals = BUDGETS[generation]
    g = torch.Generator().manual_seed(seed)
    anchors = torch.from_numpy(make_anchors(*CANVAS))
    a, b = anchors.shape[0], len(reals)
    gt = torch.zeros(b, slots, 4)
    gt_mask = torch.zeros(b, slots, dtype=torch.bool)
    for i, real in enumerate(reals):
        xy = torch.rand(real, 2, generator=g) * 0.8
        wh = 0.02 + torch.rand(real, 2, generator=g) * 0.3
        gt[i, :real] = torch.cat([xy, (xy + wh).clamp(max=1.0)], dim=1)
        gt_mask[i, :real] = True
    n_cand = cfg.post_nms_train + slots
    args = (
        anchors,
        torch.randn(b, a, 2, generator=g),
        torch.randn(b, a, 4, generator=g) * 0.2,
        torch.tensor([[1.0, 1.0], [0.75, 0.9]]),
        gt,
        torch.randint(0, 80, (b, slots), generator=g, dtype=torch.int32),
        gt_mask,
        pfr.TrainNoise(*(torch.rand(b, n, generator=g) for n in (a, a, n_cand, n_cand))),
    )
    return cfg, [x.to(device) if isinstance(x, torch.Tensor) else type(x)(*(t.to(device) for t in x))
                 for x in args]


@pytest.mark.card
@pytest.mark.parametrize("generation", list(BUDGETS))
def test_train_targets_make_no_device_sync(generation):
    device = _card()
    cfg, args = _batch(generation, device)
    pfr.train_targets(cfg, *args)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rpn_tg, roi_tg = pfr.train_targets(cfg, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((rpn_tg.labels == 1).sum()) > 0 and int(roi_tg.is_pos.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("generation", list(BUDGETS))
def test_train_targets_on_the_card_equal_the_one_image_entry_points(generation):
    device = _card()
    cfg, args = _batch(generation, device, seed=1)
    anchors, _, _, extents, gt, gt_labels, gt_mask, noise = args
    stages = {}
    rpn_tg, roi_tg = pfr.train_targets(
        cfg, *args, on_stage=lambda name, result: stages.__setitem__(name, result)
    )
    props = stages["propose"]
    for i in range(gt.shape[0]):
        want_rpn = pt.rpn_targets(
            anchors, gt[i], gt_mask[i], extents[i], noise.rpn_pos[i], noise.rpn_neg[i],
            pos_iou=cfg.rpn_pos_iou, neg_iou=cfg.rpn_neg_iou, pos_quota=cfg.rpn_pos_quota,
            total_quota=cfg.rpn_total_quota, allow_ties=cfg.rpn_allow_ties,
            boundary_filter=cfg.rpn_boundary_filter,
        )
        want_roi = pt.frcnn_targets(
            props.rois[i], props.valid[i], gt[i], gt_labels[i], gt_mask[i], noise.roi_pos[i],
            noise.roi_neg[i], num_samples=cfg.roi_samples, pos_quota=cfg.roi_pos_quota,
            pos_iou=cfg.roi_pos_iou, label_offset=cfg.label_offset,
        )
        for got, want in ((rpn_tg, want_rpn), (roi_tg, want_roi)):
            for field, value in zip(want._fields, want):
                assert torch.equal(getattr(got, field)[i], value), (generation, field, i)


@pytest.mark.card
def test_cascade_stages_make_no_device_sync():
    """Cascade R-CNN's RoI stages (``train_losses``: each stage's head and
    loss terms, the refine, the later stages' match and sampling, the
    weighted loss) after ``train_targets``, at the cascade's budgets and
    800x1344, a batch of 2 with 3 and 42 gt in 100 slots."""
    device = _card()
    cfg = pfr.CASCADE_CONFIG
    model, _ = pfr.build_model("cascade")
    pfr.init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    g = torch.Generator().manual_seed(3)
    images = torch.randn(2, *CANVAS, 3, generator=g).to(device)
    extents = torch.tensor([[1.0, 1.0], [0.75, 0.9]], device=device)
    gt = torch.zeros(2, 100, 4)
    gt_mask = torch.zeros(2, 100, dtype=torch.bool)
    for i, real in enumerate((3, 42)):
        xy = torch.rand(real, 2, generator=g) * 0.7
        wh = 0.05 + torch.rand(real, 2, generator=g) * 0.25
        gt[i, :real] = torch.cat([xy, (xy + wh).clamp(max=1.0)], dim=1)
        gt_mask[i, :real] = True
    gt, gt_mask = gt.to(device), gt_mask.to(device)
    gt_labels = torch.randint(1, 91, (2, 100), generator=g, dtype=torch.int32).to(device)
    anchors = torch.from_numpy(model.canvas_anchors(*CANVAS)).to(device)
    gen = torch.Generator(device=device).manual_seed(5)

    def stages(mode):
        feats = model.features(images.permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
        noise = pfr.draw_train_noise(gen, cfg, 2, anchors.shape[0], 100, device)
        rpn_tg, roi_tg = pfr.train_targets(
            cfg, anchors, rpn_cls, rpn_reg, extents, gt, gt_labels, gt_mask, noise
        )
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            return pfr.train_losses(
                model, cfg, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, CANVAS,
                extents=extents, gt=(gt, gt_labels, gt_mask), noise=noise,
            )
        finally:
            torch.cuda.set_sync_debug_mode(0)

    stages(0)  # builds the kernels
    out = stages("error")
    assert torch.isfinite(out.losses.total) and int(out.num_pos_roi) > 0

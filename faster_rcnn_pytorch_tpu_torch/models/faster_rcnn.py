"""Both Faster R-CNN generations and their predict.

Counterpart of ``faster_rcnn_pytorch_tpu/models/faster_rcnn.py``:

* :class:`LegacyFRCNN`: VGG16, conv5_3 features at stride 16, 9-anchor
  RPN, 7x7 RoIPool head with the shared 4096-wide FC trunk.
* :class:`FPNFRCNN`: ResNet50-FPN, a 3-anchor RPN shared over P2..P6,
  7x7 MultiScaleRoIAlign over P2..P5, 1024-wide FC trunk.

Images live on a padded canvas; box coordinates are normalised to
[0, 1] of the canvas, and each image's valid extent (w_frac, h_frac)
flows through proposal selection.

The modules' parameter names are the reference layouts, so the state
dicts from ``export_legacy_torch_state_dict`` / ``export_fpn_torch_state_dict``
(or a reference ``.pth.tar``) load with ``strict=True``. Both layouts hold
the shared classifier twice (``classifier.*`` and
``fast_rcnn_head.classifier.*`` / ``frcnn_head.classifier.*``): one
``nn.Sequential`` is registered under both names.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from faster_rcnn_pytorch_tpu_torch.models.anchors import fpn_anchors, legacy_anchors
from faster_rcnn_pytorch_tpu_torch.models.losses import CountReduce, LossBreakdown, frcnn_loss
from faster_rcnn_pytorch_tpu_torch.models.rpn import RPNHead, propose_batch, softmax
from faster_rcnn_pytorch_tpu_torch.models.targets import (
    REG_STD,
    RoITargets,
    RPNTargets,
    roi_match,
    rpn_targets,
    sample_roi_targets,
)
from faster_rcnn_pytorch_tpu_torch.models.resnet import Bottleneck, ResNet50FPN
from faster_rcnn_pytorch_tpu_torch.models.vgg import VGG16Features
from faster_rcnn_pytorch_tpu_torch.ops.boxes import cxcy_to_xy, decode, xy_to_cxcy
from faster_rcnn_pytorch_tpu_torch.ops.nms import multiclass_nms_batch
from faster_rcnn_pytorch_tpu_torch.ops.roi_align import multiscale_roi_align_batch
from faster_rcnn_pytorch_tpu_torch.ops.roi_pool import roi_pool_batch


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static hyper-parameters of one model generation (the JAX package's
    ``DetectorConfig``)."""

    num_classes: int = 21
    pre_nms_train: int = 12000
    post_nms_train: int = 2000
    pre_nms_test: int = 6000
    post_nms_test: int = 300
    rpn_nms_iou: float = 0.7
    rpn_nms_tile: int = 512
    rpn_nms_tile_train: int = 0
    proposal_min_size: float = 1.0 / 1000.0
    roi_samples: int = 128
    roi_pos_quota: int = 32
    roi_pos_iou: float = 0.5
    label_offset: int = 1
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_pos_quota: int = 128
    rpn_total_quota: int = 256
    rpn_allow_ties: bool = False
    rpn_boundary_filter: bool = True
    score_threshold: float = 0.05
    nms_iou: float = 0.3
    max_detections: int = 100


LEGACY_CONFIG = DetectorConfig(rpn_nms_tile_train=1024)

FPN_CONFIG = DetectorConfig(
    num_classes=91,
    pre_nms_train=4000,
    post_nms_train=1000,
    pre_nms_test=2000,
    post_nms_test=1000,
    proposal_min_size=10.0 / 1000.0,
    roi_samples=512,
    roi_pos_quota=128,
    label_offset=0,
    rpn_allow_ties=True,
    rpn_boundary_filter=False,
)


def scale_columns(x: torch.Tensor, factors) -> torch.Tensor:
    """``x [..., k]`` with column ``i`` multiplied by the Python number
    ``factors[i]`` (in ``x``'s dtype, as a tensor of them would multiply):
    no constant tensor is copied to the device, so no host sync."""
    return torch.stack([x[..., i] * f for i, f in enumerate(factors)], dim=-1)


# Canvases whose device anchors a model keeps: train, eval and serve use
# a few fixed buckets; the demo pads each image to its own canvas.
ANCHOR_CACHE_SIZE = 4


def device_anchors(model, height: int, width: int, device) -> torch.Tensor:
    """The model's canvas anchors as a float32 tensor on ``device``, kept
    on the model for the last ``ANCHOR_CACHE_SIZE`` canvases and devices
    used: a copy from the host on every call would synchronise with it.
    (Under ``torch.export`` a missing entry is made but not kept: the
    program holds it as a constant.)"""
    cache = model.__dict__.setdefault("_device_anchors", collections.OrderedDict())
    key = (height, width, str(torch.device(device)))
    anchors = cache.get(key)
    if anchors is not None:
        cache.move_to_end(key)
        return anchors
    anchors = torch.from_numpy(model.canvas_anchors(height, width)).to(device)
    if not torch.compiler.is_exporting():
        cache[key] = anchors
        if len(cache) > ANCHOR_CACHE_SIZE:
            cache.popitem(last=False)
    return anchors


def _trunk(in_features: int, width: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(in_features, width),
        nn.ReLU(inplace=True),
        nn.Linear(width, width),
        nn.ReLU(inplace=True),
    )


class FastRCNNHead(nn.Module):
    """RoI head: the shared classifier, then class scores and boxes."""

    def __init__(self, classifier: nn.Sequential, num_classes: int):
        super().__init__()
        width = classifier[2].out_features
        self.classifier = classifier
        self.cls_head = nn.Linear(width, num_classes)
        self.reg_head = nn.Linear(width, num_classes * 4)

    def forward(self, pooled: torch.Tensor):
        """``[B, S, C, 7, 7]`` pooled rois -> float32 ``([B, S, classes],
        [B, S, 4 * classes])``; the ``(C, 7, 7)`` flatten meets fc6 in the
        reference layout."""
        b, s = pooled.shape[:2]
        x = self.classifier(pooled.reshape(b, s, -1))
        return self.cls_head(x).float(), self.reg_head(x).float()


class LegacyFRCNN(nn.Module):
    """VGG16 Faster R-CNN: conv5_3 features at stride 16, 9-anchor RPN,
    7x7 RoIPool head with the shared 4096-wide FC trunk."""

    # Parameters the loss never reaches (none here; see FPNFRCNN).
    frozen_prefixes: tuple[str, ...] = ()

    def __init__(self, num_classes: int = 21):
        super().__init__()
        self.num_classes = num_classes
        self.extractor = VGG16Features()
        self.rpn = RPNHead(num_anchors=9, channels=512)
        self.classifier = _trunk(512 * 7 * 7, 4096)
        self.fast_rcnn_head = FastRCNNHead(self.classifier, num_classes)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, 3, H, W]`` -> ``[B, 512, H//16, W//16]``."""
        return self.extractor(images)

    def rpn_out(self, feats: torch.Tensor):
        return self.rpn(feats)

    def head(self, feats: torch.Tensor, rois: torch.Tensor, plain: bool = False):
        """feats ``[B, 512, h, w]``, rois ``[B, S, 4]`` in [0, 1] ->
        float32 ``([B, S, C], [B, S, 4C])``. Rois are scaled to feature
        cells before RoIPool. ``plain`` is for tests only: the plain
        RoIPool in place of the kernel."""
        _, _, fh, fw = feats.shape
        scaled = scale_columns(rois, (fw, fh, fw, fh))
        pooled = roi_pool_batch(feats, scaled, 1.0, output_size=7, plain=plain)
        return self.fast_rcnn_head(pooled)

    def canvas_anchors(self, height: int, width: int):
        return legacy_anchors(height, width)

    def init_stds(self) -> dict:
        """The reference's head inits; every other conv and linear layer is
        He-normal (keeps activations O(1) through the 15 ReLU layers)."""
        return {
            self.rpn.inter_layer: 0.01,
            self.rpn.cls_layer: 0.01,
            self.rpn.reg_layer: 0.01,
            self.fast_rcnn_head.cls_head: 0.01,
            self.fast_rcnn_head.reg_head: 0.001,
        }


class FPNFRCNN(nn.Module):
    """ResNet50-FPN Faster R-CNN: P2..P6 at strides 4..64, one 3-anchor
    RPN head shared over the levels, 7x7 MultiScaleRoIAlign over P2..P5
    and the shared 1024-wide FC trunk."""

    strides = (4, 8, 16, 32, 64)
    # The frozen stem and layer1: detached in the forward, so the loss
    # gives them no gradient (the optimizer still decays them).
    frozen_prefixes = ("backbone.body.conv1.", "backbone.body.layer1.")

    def __init__(self, num_classes: int = 91):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet50FPN()
        self.rpn = nn.ModuleDict({"rpn_head": RPNHead(num_anchors=3, channels=256)})
        self.classifier = _trunk(256 * 7 * 7, 1024)
        self.frcnn_head = FastRCNNHead(self.classifier, num_classes)

    def features(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``[B, 3, H, W]`` -> (P2, P3, P4, P5, P6)."""
        return self.backbone(images)

    def rpn_out(self, feats):
        """The shared head per level, concatenated level-major like the
        anchors: ``([B, A, 2], [B, A, 4])`` float32."""
        outs = [self.rpn["rpn_head"](f) for f in feats]
        return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)

    def head(self, feats, rois: torch.Tensor, canvas_hw, plain: bool = False):
        """RoI head over P2..P5: rois ``[B, S, 4]`` in [0, 1] are scaled by
        the canvas (w, h, w, h) to pixels for MultiScaleRoIAlign. ``plain``
        is for tests only: the plain align in place of the kernel."""
        h, w = canvas_hw
        scaled = scale_columns(rois, (w, h, w, h))
        pooled = multiscale_roi_align_batch(feats[:4], scaled, plain=plain)
        return self.frcnn_head(pooled)

    def canvas_anchors(self, height: int, width: int):
        return fpn_anchors(height, width, strides=self.strides)

    def init_stds(self) -> dict:
        """Seeded-init scales that keep P2..P6 O(1) with identity FrozenBN
        (std about 1-3 at 800x1344): each bottleneck's last conv at 0.25
        and its downsample at 0.7 of He, so the residual sums do not
        double the variance block after block; the FPN convs, whose inputs
        are not rectified, at ``1 / sqrt(fan_in)``. The heads as the
        reference inits them, but N(0, 0.02) for the class head: with the
        reference's 0.01 the top class probabilities of random images sit
        at about 0.05-0.11 of 91 classes, on the 0.05 threshold, so whether
        there are detections at all would hinge on rounding; 0.02 lifts
        them to about 0.16-0.44, still far from 1.0, where saturated ties
        would make the order device-dependent."""
        stds = {}
        for blk in self.backbone.body.modules():
            if isinstance(blk, Bottleneck):
                stds[blk.conv3] = 0.25 * _he_std(blk.conv3)
                if blk.downsample is not None:
                    stds[blk.downsample[0]] = 0.7 * _he_std(blk.downsample[0])
        for conv in self.backbone.fpn.modules():
            if isinstance(conv, nn.Conv2d):
                stds[conv] = 1.0 / math.sqrt(conv.weight[0].numel())
        head = self.rpn["rpn_head"]
        stds.update(
            {
                head.inter_layer: 0.01,
                head.cls_layer: 0.01,
                head.reg_layer: 0.01,
                self.frcnn_head.cls_head: 0.02,
                self.frcnn_head.reg_head: 0.001,
            }
        )
        return stds


def _he_std(m: nn.Module) -> float:
    return math.sqrt(2.0 / m.weight[0].numel())


def init_weights(model, generator: torch.Generator):
    """Seeded random init: N(0, std) weights with the model's
    ``init_stds`` and He-normal elsewhere, zero biases. FrozenBN keeps its
    identity statistics (scale 1, bias 0, mean 0, var 1)."""
    small = model.init_stds()
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            std = small.get(m, _he_std(m))
            w = torch.randn(m.weight.shape, generator=generator) * std
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return model


class TrainStepOutput(NamedTuple):
    losses: LossBreakdown
    num_pos_roi: torch.Tensor
    num_pos_rpn: torch.Tensor


class TrainNoise(NamedTuple):
    """Uniform noise of the four sampling quotas, per image. The JAX
    package draws each from its own key: for image ``i`` of
    ``split(rng, (B, 3))``, ``split(key[i, 0])`` gives the RPN pos/neg
    noise and ``split(key[i, 1])`` the RoI pos/neg noise."""

    rpn_pos: torch.Tensor  # [B, A]
    rpn_neg: torch.Tensor  # [B, A]
    roi_pos: torch.Tensor  # [B, post_nms_train + G]
    roi_neg: torch.Tensor  # [B, post_nms_train + G]


def draw_train_noise(
    generator: torch.Generator, b: int, num_anchors: int, num_candidates: int, device
) -> TrainNoise:
    def uniform(n):
        return torch.rand((b, n), generator=generator, device=device)

    return TrainNoise(
        uniform(num_anchors), uniform(num_anchors), uniform(num_candidates), uniform(num_candidates)
    )


def _stack(parts):
    return type(parts[0])(*(torch.stack(t) for t in zip(*parts)))


def train_targets(
    cfg: DetectorConfig,
    anchors: torch.Tensor,
    rpn_cls: torch.Tensor,
    rpn_reg: torch.Tensor,
    extents: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    noise: TrainNoise,
    plain: bool = False,
) -> tuple[RPNTargets, RoITargets]:
    """The JAX package's ``vmap`` of proposals, RPN and RoI targets, written
    out: the train-budget proposals of the batch (one NMS launch), per
    image the RPN targets; then one
    :func:`roi_match` for the batch (each image's ``[post_nms_train + G,
    4]`` candidates against its gt: the IoU kernel's match mode, one
    launch, where an image's problem passes the JAX package's gate); then
    per image the sampling. Returns both batched, ``[B, A]`` and ``[B, S]``.
    No gradient flows through them. ``plain`` (tests only) keeps the plain
    NMS sweep, and the plain match above the gate."""
    props = propose_batch(
        rpn_cls,
        rpn_reg,
        anchors,
        extents,
        pre_k=cfg.pre_nms_train,
        post_k=cfg.post_nms_train,
        nms_iou=cfg.rpn_nms_iou,
        min_size=cfg.proposal_min_size,
        nms_tile=cfg.rpn_nms_tile_train or cfg.rpn_nms_tile,
        plain=plain,
    )
    rpn_tg = []
    for i in range(rpn_cls.shape[0]):
        rpn_tg.append(
            rpn_targets(
                anchors,
                gt_boxes[i],
                gt_mask[i],
                extents[i],
                noise.rpn_pos[i],
                noise.rpn_neg[i],
                pos_iou=cfg.rpn_pos_iou,
                neg_iou=cfg.rpn_neg_iou,
                pos_quota=cfg.rpn_pos_quota,
                total_quota=cfg.rpn_total_quota,
                allow_ties=cfg.rpn_allow_ties,
                boundary_filter=cfg.rpn_boundary_filter,
            )
        )
    cand = torch.cat([props.rois, gt_boxes], dim=1)
    cand_valid = torch.cat([props.valid, gt_mask], dim=1)
    iou_max, iou_argmax = roi_match(cand, cand_valid, gt_boxes, gt_mask, plain=plain)
    roi_tg = [
        sample_roi_targets(
            cand[i],
            cand_valid[i],
            iou_max[i],
            iou_argmax[i],
            gt_boxes[i],
            gt_labels[i],
            noise.roi_pos[i],
            noise.roi_neg[i],
            num_samples=cfg.roi_samples,
            pos_quota=cfg.roi_pos_quota,
            pos_iou=cfg.roi_pos_iou,
            label_offset=cfg.label_offset,
        )
        for i in range(cand.shape[0])
    ]
    return _stack(rpn_tg), _stack(roi_tg)


def train_losses(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    feats,
    rpn_cls: torch.Tensor,
    rpn_reg: torch.Tensor,
    rpn_tg: RPNTargets,
    roi_tg: RoITargets,
    canvas_hw: tuple[int, int],
    plain: bool = False,
    count_reduce: CountReduce | None = None,
) -> TrainStepOutput:
    """The head on the sampled rois (either generation; FPN aligns in
    pixels of the ``canvas_hw`` canvas), the regression row of each target
    class, and the four-part loss (``count_reduce``: its denominators
    over the data group, ``models/losses.py``)."""
    head_cls, head_reg = _head_apply(model, feats, roi_tg.rois, canvas_hw, plain)
    b, s = roi_tg.labels.shape
    head_reg = head_reg.reshape(b, s, cfg.num_classes, 4)
    safe_cls = roi_tg.labels.clamp(0, cfg.num_classes - 1).long()
    head_reg = head_reg.gather(2, safe_cls[:, :, None, None].expand(b, s, 1, 4))[:, :, 0, :]
    losses = frcnn_loss(
        (rpn_cls, rpn_reg, head_cls, head_reg),
        (rpn_tg.labels, rpn_tg.reg_targets, roi_tg.labels, roi_tg.reg_targets),
        count_reduce,
    )
    return TrainStepOutput(
        losses=losses,
        num_pos_roi=roi_tg.is_pos.sum(),
        num_pos_rpn=(rpn_tg.labels == 1).sum(),
    )


def forward_train(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    images: torch.Tensor,
    extents: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: TrainNoise | None = None,
    plain: bool = False,
    count_reduce: CountReduce | None = None,
) -> TrainStepOutput:
    """One training forward pass: the losses of a padded batch.

    Args:
      images: ``[B, H, W, 3]`` normalised canvas batch (NHWC, as the
        loader gives it; the network runs NCHW).
      extents: ``[B, 2]`` (w_frac, h_frac) valid extent per image.
      gt_boxes: ``[B, G, 4]`` xyxy in [0, 1] canvas coords; gt_labels
        ``[B, G]``; gt_mask ``[B, G]``.
      generator: draws the sampling noise (on the images' device) unless
        ``noise`` is given; a test hands the JAX package's noise over. The
        noise is sized by the model's anchors on this canvas and
        ``post_nms_train + G`` candidate rois.
      plain: tests only: the plain RoIPool or MultiScaleRoIAlign (forward
        and backward), the plain NMS sweep and the plain IoU of the RoI
        targets in place of the kernels.
      count_reduce: data parallelism: the loss's counts over the data
        group (``models/losses.py``).

    The JAX package's slab-batched VGG stem (``train=True``) is a TPU
    layout with the same numbers; this is the plain stack.
    """
    b, canvas_h, canvas_w = images.shape[:3]
    dev = images.device
    anchors = device_anchors(model, canvas_h, canvas_w, dev)
    feats = model.features(images.permute(0, 3, 1, 2).contiguous())
    rpn_cls, rpn_reg = model.rpn_out(feats)
    if noise is None:
        n_cand = cfg.post_nms_train + gt_boxes.shape[1]
        noise = draw_train_noise(generator, b, anchors.shape[0], n_cand, dev)
    rpn_tg, roi_tg = train_targets(
        cfg, anchors, rpn_cls, rpn_reg, extents, gt_boxes, gt_labels, gt_mask, noise, plain
    )
    return train_losses(
        model, cfg, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, (canvas_h, canvas_w), plain,
        count_reduce,
    )


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4] xyxy in [0,1] canvas coords
    labels: torch.Tensor  # [B, D] 0-based foreground class ids (-1 pad)
    scores: torch.Tensor  # [B, D]
    valid: torch.Tensor  # [B, D]


PREDICT_STAGES = ("h2d", "backbone", "rpn_head", "propose", "roi_head", "decode", "class_nms")


def _head_apply(model, feats, rois, canvas_hw, plain):
    """The RoI head of either generation: FPN aligns in canvas pixels and
    needs the canvas, legacy pools in feature cells and does not."""
    if isinstance(model, FPNFRCNN):
        return model.head(feats, rois, canvas_hw, plain=plain)
    return model.head(feats, rois, plain=plain)


@torch.no_grad()
def predict(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    images: torch.Tensor,
    extents: torch.Tensor,
    score_threshold: float | None = None,
    plain: bool = False,
    on_stage: Callable[[str, object], None] | None = None,
) -> Detections:
    """Test-time forward of either generation: proposals, then
    :func:`detect`: head on all rois, softmax, deltas un-normalised by
    REG_STD and decoded against the rois, clamp, per-class threshold +
    NMS, labels 0-based.

    Args:
      images: ``[B, H, W, 3]`` normalised canvas batch (the JAX package's
        layout; the network runs NCHW).
      extents: ``[B, 2]`` (w_frac, h_frac).
      plain: tests only; hold the kernels' path against the plain RoIPool
        or MultiScaleRoIAlign and the plain NMS sweep.
      on_stage: called as ``on_stage(name, result)`` as each of
        :data:`PREDICT_STAGES` ends (``h2d`` is the anchors' copy;
        ``decode`` hands over the class probabilities), so a timer can
        sync the device between stages.
    """
    mark = on_stage or (lambda name, result: None)
    canvas_h, canvas_w = images.shape[1:3]
    dev = images.device
    dtype = next(model.parameters()).dtype
    anchors = device_anchors(model, canvas_h, canvas_w, dev)
    thres = cfg.score_threshold if score_threshold is None else score_threshold
    mark("h2d", anchors)

    feats = model.features(images.permute(0, 3, 1, 2).to(dtype).contiguous())
    mark("backbone", feats)
    rpn_cls, rpn_reg = model.rpn_out(feats)
    mark("rpn_head", rpn_cls)
    props = propose_batch(
        rpn_cls,
        rpn_reg,
        anchors,
        extents,
        pre_k=cfg.pre_nms_test,
        post_k=cfg.post_nms_test,
        nms_iou=cfg.rpn_nms_iou,
        min_size=cfg.proposal_min_size,
        nms_tile=cfg.rpn_nms_tile,
        plain=plain,
    )
    mark("propose", props.rois)
    return detect(model, cfg, feats, props.rois, props.valid, (canvas_h, canvas_w), thres, plain, mark)


@torch.no_grad()
def detect(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    feats,
    rois: torch.Tensor,
    valid: torch.Tensor,
    canvas_hw: tuple[int, int],
    score_threshold: float,
    plain: bool = False,
    on_stage: Callable[[str, object], None] | None = None,
) -> Detections:
    """The stages of :func:`predict` after the proposals: the RoI head on
    ``rois`` ``[B, S, 4]`` (``valid`` ``[B, S]``), softmax, deltas
    un-normalised by REG_STD and decoded against the rois, clamp, and the
    per-class threshold + NMS."""
    mark = on_stage or (lambda name, result: None)
    b, s = rois.shape[:2]
    head_cls, head_reg = _head_apply(model, feats, rois, canvas_hw, plain)
    mark("roi_head", head_cls)
    probs = softmax(head_cls)
    probs = torch.where(valid[:, :, None], probs, 0.0)
    reg = scale_columns(head_reg.reshape(b, s, cfg.num_classes, 4), REG_STD)
    rois_c = xy_to_cxcy(rois)[:, :, None, :]
    boxes = cxcy_to_xy(decode(reg, rois_c)).clamp(0.0, 1.0)
    mark("decode", probs)

    dets = Detections(
        *multiclass_nms_batch(
            boxes,
            probs,
            score_threshold,
            cfg.nms_iou,
            num_classes=cfg.num_classes,
            per_class_k=cfg.max_detections,
            max_det=cfg.max_detections,
            plain=plain,
        )
    )
    mark("class_nms", dets)
    return dets


def label_offset_for(generation: str, data_type: str) -> int:
    """Dataset label -> head class index offset: the FPN generation on
    COCO consumes raw category ids (1..90, background 0), so it needs
    none; every 0-based labelling (VOC, COCO remapped to 0..79 for the
    legacy generation) shifts by 1 past the background slot."""
    return 0 if (generation == "fpn" and data_type == "coco") else 1


def build_model(
    generation: str,
    num_classes: int | None = None,
    label_offset: int | None = None,
    remat: bool = False,
):
    """Model + config factory (float32 parameters, uninitialised beyond
    PyTorch's defaults: load a state dict or call :func:`init_weights`).
    ``label_offset`` overrides the config's (see :func:`label_offset_for`).
    ``remat`` (``--remat_backbone``): the backbone recomputes its
    activations in the backward, VGG16 whole and ResNet50 per
    bottleneck; the parameters are the same."""
    models = {"legacy": (LEGACY_CONFIG, LegacyFRCNN), "fpn": (FPN_CONFIG, FPNFRCNN)}
    if generation not in models:
        raise ValueError(f"unknown generation: {generation!r}")
    cfg, model_cls = models[generation]
    overrides = {}
    if num_classes is not None:
        overrides["num_classes"] = num_classes
    if label_offset is not None:
        overrides["label_offset"] = label_offset
    cfg = dataclasses.replace(cfg, **overrides)
    model = model_cls(num_classes=cfg.num_classes)
    for m in model.modules():
        if isinstance(m, (VGG16Features, Bottleneck)):
            m.remat = remat
    return model, cfg

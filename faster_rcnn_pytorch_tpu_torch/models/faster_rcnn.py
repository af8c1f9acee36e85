"""Both Faster R-CNN generations, Cascade R-CNN, and their predict.

Counterpart of ``faster_rcnn_pytorch_tpu/models/faster_rcnn.py``:

* :class:`LegacyFRCNN`: VGG16, conv5_3 features at stride 16, 9-anchor
  RPN, 7x7 RoIPool head with the shared 4096-wide FC trunk.
* :class:`FPNFRCNN`: ResNet50-FPN, a 3-anchor RPN shared over P2..P6,
  7x7 MultiScaleRoIAlign over P2..P5, 1024-wide FC trunk.
* :class:`CascadeRCNN` (no JAX counterpart): the FPN trunk and RPN, then
  three RoI heads, each trained on the boxes the one before it refined,
  at rising IoU thresholds (Cai & Vasconcelos 2018, arXiv:1712.00726).

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
import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from faster_rcnn_pytorch_tpu_torch.models.anchors import fpn_anchors, legacy_anchors
from faster_rcnn_pytorch_tpu_torch.models.losses import (
    CountReduce,
    LossBreakdown,
    frcnn_loss,
    stage_sums,
)
from faster_rcnn_pytorch_tpu_torch.models.rpn import RPNHead, propose_batch, softmax
from faster_rcnn_pytorch_tpu_torch.models.targets import (
    REG_STD,
    RoITargets,
    RPNTargets,
    anchor_inside,
    roi_match,
    rpn_labels,
    sample_roi_targets,
)
from faster_rcnn_pytorch_tpu_torch.models.resnet import Bottleneck, ResNet50FPN
from faster_rcnn_pytorch_tpu_torch.models.vgg import VGG16Features
from faster_rcnn_pytorch_tpu_torch.ops.boxes import cxcy_to_xy, decode, rpn_match, xy_to_cxcy
from faster_rcnn_pytorch_tpu_torch.ops.nms import multiclass_nms_batch
from faster_rcnn_pytorch_tpu_torch.ops.roi_align import multiscale_roi_align_batch
from faster_rcnn_pytorch_tpu_torch.ops.roi_pool import roi_pool_batch
from faster_rcnn_pytorch_tpu_torch.utils.logging import count, span, stage_spans


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
    # Cascade R-CNN's RoI stages (empty: one head, :func:`roi_stages`):
    # each stage's IoU threshold, its regression stds (flat, four a stage)
    # and its weight in the loss.
    stage_ious: tuple = ()
    stage_reg_stds: tuple = ()
    stage_loss_weights: tuple = ()


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

# mmdetection's cascade-rcnn_r50_fpn_1x_coco: the FPN budgets, three stages.
CASCADE_CONFIG = dataclasses.replace(
    FPN_CONFIG,
    stage_ious=(0.5, 0.6, 0.7),
    stage_reg_stds=(0.1, 0.1, 0.2, 0.2, 0.05, 0.05, 0.1, 0.1, 0.033, 0.033, 0.067, 0.067),
    stage_loss_weights=(1.0, 0.5, 0.25),
)

# The largest log-scale a box regression may take (mmdetection's and
# Detectron2's ``log(1000 / 16)``): a cascade decodes boxes it trains on.
BOX_SCALE_CLAMP = math.log(1000.0 / 16.0)


class RoIStage(NamedTuple):
    """One RoI head stage: the IoU at which a candidate turns positive,
    the four stds of its regression, its weight in the loss."""

    iou: float
    reg_std: tuple
    weight: float


def roi_stages(cfg) -> tuple[RoIStage, ...]:
    """The RoI stages in order: a cascade's from its ``stage_*`` fields,
    otherwise one head at ``roi_pos_iou`` with :data:`REG_STD` and weight
    1 (also for a config without the fields, the JAX package's, which the
    parity tests hand over). Every choice between one head and a cascade
    reads this."""
    ious = getattr(cfg, "stage_ious", ())
    if not ious:
        return (RoIStage(cfg.roi_pos_iou, REG_STD, 1.0),)
    stds = cfg.stage_reg_stds
    return tuple(
        RoIStage(iou, tuple(stds[4 * t : 4 * t + 4]), w)
        for t, (iou, w) in enumerate(zip(ious, cfg.stage_loss_weights))
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
    """RoI head: the shared classifier, then class scores and boxes (one
    box a class, or one for all with ``class_agnostic``)."""

    def __init__(self, classifier: nn.Sequential, num_classes: int, class_agnostic: bool = False):
        super().__init__()
        width = classifier[2].out_features
        self.classifier = classifier
        self.cls_head = nn.Linear(width, num_classes)
        self.reg_head = nn.Linear(width, 4 if class_agnostic else num_classes * 4)

    def forward(self, pooled: torch.Tensor):
        """``[B, S, C, 7, 7]`` pooled rois -> float32 ``([B, S, classes],
        [B, S, 4 * classes])`` (``[B, S, 4]`` class-agnostic); the ``(C, 7,
        7)`` flatten meets fc6 in the reference layout."""
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

    def head(self, feats: torch.Tensor, rois: torch.Tensor, canvas_hw, stage: int = 0):
        """feats ``[B, 512, h, w]``, rois ``[B, S, 4]`` in [0, 1] ->
        float32 ``([B, S, C], [B, S, 4C])``. Rois are scaled to feature
        cells before RoIPool, so the canvas ``canvas_hw`` is not needed,
        and there is one stage: the arguments are :meth:`FPNFRCNN.head`'s."""
        _, _, fh, fw = feats.shape
        scaled = scale_columns(rois, (fw, fh, fw, fh))
        pooled = roi_pool_batch(feats, scaled, 1.0, output_size=7)
        return self.fast_rcnn_head(pooled)

    def canvas_anchors(self, height: int, width: int):
        return legacy_anchors(height, width)

    def head_stds(self) -> dict:
        """The heads' N(0, std) inits, the JAX package's (and the
        reference's): the RPN convs at 0.01, the class head at 0.01, the
        box head at 0.001."""
        return {
            self.rpn.inter_layer: 0.01,
            self.rpn.cls_layer: 0.01,
            self.rpn.reg_layer: 0.01,
            self.fast_rcnn_head.cls_head: 0.01,
            self.fast_rcnn_head.reg_head: 0.001,
        }

    def init_stds(self) -> dict:
        """The fixtures' init (:func:`init_weights`): the heads'; every
        other conv and linear layer is He-normal (keeps activations O(1)
        through the 15 ReLU layers)."""
        return self.head_stds()


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
        self._add_roi_heads(num_classes)

    def _add_roi_heads(self, num_classes: int) -> None:
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

    def head(self, feats, rois: torch.Tensor, canvas_hw, stage: int = 0):
        """RoI head (``stage_heads()[stage]``) over P2..P5: rois ``[B, S,
        4]`` in [0, 1] are scaled by the canvas (w, h, w, h) to pixels for
        MultiScaleRoIAlign."""
        h, w = canvas_hw
        scaled = scale_columns(rois, (w, h, w, h))
        pooled = multiscale_roi_align_batch(feats[:4], scaled)
        return self.stage_heads()[stage](pooled)

    def stage_heads(self) -> list:
        """The RoI head of each stage of :func:`roi_stages`."""
        return [self.frcnn_head]

    def canvas_anchors(self, height: int, width: int):
        return fpn_anchors(height, width, strides=self.strides)

    def init_stds(self) -> dict:
        """The fixtures' init (:func:`init_weights`): scales that keep
        P2..P6 O(1) with identity FrozenBN (std about 1-3 at 800x1344):
        each bottleneck's last conv at 0.25
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
        stds.update(self.head_stds())
        stds.update({layer: 0.02 for layer in self.class_layers()})
        return stds

    def class_layers(self) -> list:
        return [h.cls_head for h in self.stage_heads()]

    def head_stds(self) -> dict:
        """The heads' N(0, std) inits, the JAX package's (and the
        reference's): the shared RPN head's convs at 0.01, each stage's
        class head at 0.01 and box head at 0.001."""
        head = self.rpn["rpn_head"]
        stds = {head.inter_layer: 0.01, head.cls_layer: 0.01, head.reg_layer: 0.01}
        for h in self.stage_heads():
            stds.update({h.cls_head: 0.01, h.reg_head: 0.001})
        return stds


class CascadeRCNN(FPNFRCNN):
    """Cascade R-CNN R50-FPN: :class:`FPNFRCNN`'s trunk and RPN, then one
    RoI head a stage (``roi_heads[t]``: MultiScaleRoIAlign 7x7, two fc
    layers of 1024, a class layer and a class-agnostic box layer), each
    with its own weights. Stage ``t + 1`` pools the boxes that stage ``t``
    regressed (:func:`train_losses`, :func:`detect`)."""

    def _add_roi_heads(self, num_classes: int) -> None:
        self.roi_heads = nn.ModuleList(
            FastRCNNHead(_trunk(256 * 7 * 7, 1024), num_classes, class_agnostic=True)
            for _ in CASCADE_CONFIG.stage_ious
        )

    def stage_heads(self) -> list:
        return list(self.roi_heads)


def _he_std(m: nn.Module) -> float:
    return math.sqrt(2.0 / m.weight[0].numel())


# The std of a standard normal cut at +-2: flax's ``variance_scaling``
# divides by it so that its truncated normal keeps the asked-for variance.
TRUNCATED_NORMAL_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A standard normal cut at +-2 (std ``TRUNCATED_NORMAL_STD``), drawn
    by rejection: every draw outside the cut is drawn again until none is
    left (4.6% the first time). ``torch.nn.init.trunc_normal_`` draws the
    same distribution through ``erfinv``, 8x slower on a CPU core: 8 s
    for the legacy fc6."""
    flat = torch.empty(shape).normal_(generator=generator).view(-1)
    idx = (flat.abs() > 2).nonzero().squeeze(1)
    while idx.numel():
        redraw = torch.randn(idx.numel(), generator=generator)
        flat[idx] = redraw
        idx = idx[redraw.abs() > 2]
    return flat.view(shape)


def init_detector_weights(model, generator: torch.Generator):
    """The fresh init every CLI starts from
    (``utils/checkpoint.py::init_params``): the distributions of the JAX package's ``init_detector_params``, layer
    for layer, drawn from ``generator`` (the JAX PRNG stream is not
    reproduced). The heads get N(0, std) from the model's ``head_stds``;
    every other conv and linear layer (VGG16's convs; ResNet50's, stem and
    downsample included; the FPN's laterals and outputs; fc6 and fc7)
    flax's default ``lecun_normal``: a normal of std
    ``sqrt(1 / fan_in) / TRUNCATED_NORMAL_STD`` cut at twice that std,
    whose std is then ``sqrt(1 / fan_in)``, with ``fan_in`` the inputs of
    one output unit (``cin * kh * kw``). Biases are zero; FrozenBN keeps
    its identity statistics."""
    heads = model.head_stds()
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            if m in heads:
                w = torch.empty(m.weight.shape).normal_(0.0, heads[m], generator=generator)
            else:
                std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNCATED_NORMAL_STD
                w = _truncated_normal(m.weight.shape, generator) * std
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return model


def init_weights(model, generator: torch.Generator):
    """The fixtures' seeded random init, *not* the JAX package's
    distribution (that is :func:`init_detector_weights`, which every CLI
    uses): N(0, std) weights with the model's ``init_stds`` and He-normal
    elsewhere, zero biases. FrozenBN keeps its identity statistics (scale
    1, bias 0, mean 0, var 1). Tests that only need random weights and
    ``chip_smoke.py``'s kernel phases use it: its detections at random
    weights are free of ties."""
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


class CascadeNoise(NamedTuple):
    """:class:`TrainNoise`'s fields, then the RoI noise of each cascade
    stage after the first."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor
    stage_pos: torch.Tensor  # [B, stages - 1, roi_samples + G]
    stage_neg: torch.Tensor  # [B, stages - 1, roi_samples + G]


def draw_train_noise(
    generator: torch.Generator, cfg, b: int, num_anchors: int, gt_slots: int, device
) -> TrainNoise | CascadeNoise:
    """The step's noise, drawn in a fixed order: the RPN's positives and
    negatives ``[B, A]``, the first RoI stage's ``[B, post_nms_train +
    G]``, then for each later stage of :func:`roi_stages` (a cascade's 2,
    then 3) its positives' and negatives' ``[B, roi_samples + G]``."""

    def uniform(n):
        return torch.rand((b, n), generator=generator, device=device)

    n_cand = cfg.post_nms_train + gt_slots
    noise = TrainNoise(uniform(num_anchors), uniform(num_anchors), uniform(n_cand), uniform(n_cand))
    later = [
        (uniform(cfg.roi_samples + gt_slots), uniform(cfg.roi_samples + gt_slots))
        for _ in roi_stages(cfg)[1:]
    ]
    if not later:
        return noise
    return CascadeNoise(
        *noise, torch.stack([p for p, _ in later], 1), torch.stack([q for _, q in later], 1)
    )


TRAIN_TARGET_STAGES = ("propose", "rpn_match", "rpn_labels", "roi_match", "roi_sample")


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
    on_stage: Callable[[str, object], None] | None = None,
) -> tuple[RPNTargets, RoITargets]:
    """The JAX package's ``vmap`` of proposals, RPN and RoI targets, written
    out for the whole batch, one stage at a time: the train-budget
    proposals (one NMS launch); :func:`rpn_match` (the anchor match
    kernel, one launch); :func:`rpn_labels`, both quotas ranked over ``[B,
    A]``; :func:`roi_match` (each image's ``[post_nms_train + G, 4]``
    candidates against its gt: the IoU kernel's match mode, one launch,
    where an image's problem passes the JAX package's gate); then
    :func:`sample_roi_targets` over ``[B, post_nms_train + G]``. No stage
    loops over the images or waits for the device. Returns ``[B, A]`` and
    ``[B, S]`` targets; no gradient flows through them. Each of
    :data:`TRAIN_TARGET_STAGES` is the program's span ``train.<stage>``
    under ``train.targets`` (``utils/logging.py``), ended by its mark;
    ``on_stage`` is called as ``on_stage(name, result)`` as each stage
    ends. The spans read the host clock alone: no device sync. The RoI
    targets are those of the first stage of :func:`roi_stages`."""
    first = roi_stages(cfg)[0]
    with span("train.targets"), stage_spans("train", TRAIN_TARGET_STAGES, on_stage) as mark:
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
        )
        mark("propose", props)
        inside = anchor_inside(anchors, extents, cfg.rpn_boundary_filter)
        rpn_max, rpn_argmax, best_any = rpn_match(
            anchors, gt_boxes, gt_mask, inside, cfg.rpn_allow_ties
        )
        mark("rpn_match", best_any)
        rpn_tg = rpn_labels(
            anchors,
            gt_boxes,
            gt_mask,
            inside,
            rpn_max,
            rpn_argmax,
            best_any,
            noise.rpn_pos,
            noise.rpn_neg,
            pos_iou=cfg.rpn_pos_iou,
            neg_iou=cfg.rpn_neg_iou,
            pos_quota=cfg.rpn_pos_quota,
            total_quota=cfg.rpn_total_quota,
        )
        mark("rpn_labels", rpn_tg)
        cand = torch.cat([props.rois, gt_boxes], dim=1)
        cand_valid = torch.cat([props.valid, gt_mask], dim=1)
        iou_max, iou_argmax = roi_match(cand, cand_valid, gt_boxes, gt_mask)
        mark("roi_match", iou_max)
        roi_tg = sample_roi_targets(
            cand,
            cand_valid,
            iou_max,
            iou_argmax,
            gt_boxes,
            gt_labels,
            noise.roi_pos,
            noise.roi_neg,
            num_samples=cfg.roi_samples,
            pos_quota=cfg.roi_pos_quota,
            pos_iou=first.iou,
            label_offset=cfg.label_offset,
            reg_std=first.reg_std,
        )
        mark("roi_sample", roi_tg)
        return rpn_tg, roi_tg


def train_losses(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    feats,
    rpn_cls: torch.Tensor,
    rpn_reg: torch.Tensor,
    rpn_tg: RPNTargets,
    roi_tg: RoITargets,
    canvas_hw: tuple[int, int],
    count_reduce: CountReduce | None = None,
    extents: torch.Tensor | None = None,
    gt: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    noise: CascadeNoise | None = None,
) -> TrainStepOutput:
    """The RoI stages of :func:`roi_stages` and the loss. Stage ``t``'s
    head on its sampled rois (``roi_tg`` for the first; FPN aligns in
    pixels of the ``canvas_hw`` canvas), its cross-entropy and the
    smooth-L1 of each sample's target-class deltas (:func:`target_deltas`);
    then :func:`frcnn_loss` with the stages' weights (``count_reduce``: its
    denominators over the data group, ``models/losses.py``).

    A cascade's stage ``t + 1`` samples the boxes that stage ``t``
    regressed (:func:`next_stage_targets`, from the ``extents [B, 2]``,
    ``gt`` = ``(gt_boxes, gt_labels, gt_mask)`` and ``noise``'s stage
    fields); each stage is the span ``train.stage_head``, and while a
    profiler records, the counter ``cascade.stage3_positives`` adds the
    last stage's sampled positives over the ``B`` images. ``num_pos_roi``
    is the first stage's."""
    stages = roi_stages(cfg)
    cascade = len(stages) > 1
    stage_span = span if cascade else contextlib.nullcontext
    first, num_rois, sums = roi_tg, cfg.post_nms_train, []
    for t in range(len(stages)):
        if t:
            roi_tg = next_stage_targets(
                cfg, t - 1, roi_tg, head_reg.detach(), num_rois, extents, *gt,
                noise.stage_pos[:, t - 1], noise.stage_neg[:, t - 1],
            )
            num_rois = cfg.roi_samples
        with stage_span("train.stage_head"):
            head_cls, head_reg = model.head(feats, roi_tg.rois, canvas_hw, stage=t)
            deltas = target_deltas(head_reg, roi_tg.labels)
            sums.append(stage_sums(head_cls, deltas, roi_tg.labels, roi_tg.reg_targets))
    if cascade:
        count("cascade.stage3_positives", roi_tg.is_pos, roi_tg.is_pos.shape[0])
    losses = frcnn_loss(
        (rpn_cls, rpn_reg),
        (rpn_tg.labels, rpn_tg.reg_targets),
        sums,
        [stage.weight for stage in stages],
        count_reduce,
    )
    return TrainStepOutput(
        losses=losses,
        num_pos_roi=first.is_pos.sum(),
        num_pos_rpn=(rpn_tg.labels == 1).sum(),
    )


def target_deltas(head_reg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each sample's regression row of its target class from ``head_reg
    [B, S, 4 * C]``; a class-agnostic head's ``[B, S, 4]`` is that row."""
    b, s = labels.shape
    if head_reg.shape[-1] == 4:
        return head_reg
    head_reg = head_reg.reshape(b, s, -1, 4)
    safe_cls = labels.clamp(0, head_reg.shape[2] - 1).long()
    return head_reg.gather(2, safe_cls[:, :, None, None].expand(b, s, 1, 4))[:, :, 0, :]


def refine_boxes(
    rois: torch.Tensor, reg: torch.Tensor, std, extents: torch.Tensor
) -> torch.Tensor:
    """A cascade stage's boxes: its class-agnostic deltas ``reg [B, S, 4]``
    times ``std``, the log-scales capped at :data:`BOX_SCALE_CLAMP`,
    decoded against ``rois [B, S, 4]`` and clipped to each image's extent
    ``extents [B, 2]`` (w_frac, h_frac)."""
    d = scale_columns(reg, std)
    d = torch.cat([d[..., :2], d[..., 2:].clamp(max=BOX_SCALE_CLAMP)], dim=-1)
    boxes = cxcy_to_xy(decode(d, xy_to_cxcy(rois)))
    hi = torch.cat([extents, extents], dim=-1).to(boxes.dtype)
    return torch.minimum(boxes.clamp(min=0.0), hi[:, None, :])


@torch.no_grad()
def next_stage_targets(
    cfg: DetectorConfig,
    t: int,
    roi_tg: RoITargets,
    reg: torch.Tensor,
    num_rois: int,
    extents: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
) -> RoITargets:
    """Stage ``t + 1``'s targets from stage ``t``'s: its ``S`` sampled rois
    refined by its detached deltas ``reg [B, S, 4]`` (:func:`refine_boxes`),
    the slots that held padding or a gt (``index >= num_rois``, the
    candidates before the gt) masked out (mmdetection drops them; a mask
    keeps the shape), the gt appended again, then :func:`roi_match` and
    :func:`sample_roi_targets` at stage ``t + 1``'s IoU threshold and
    stds, with ``pos_noise`` / ``neg_noise`` ``[B, S + G]``. The spans
    ``train.refine``, ``train.stage_match`` and ``train.stage_sample``;
    no sync."""
    stage, nxt = roi_stages(cfg)[t : t + 2]
    with span("train.refine"):
        boxes = refine_boxes(roi_tg.rois, reg, stage.reg_std, extents)
        valid = roi_tg.valid & (roi_tg.index < num_rois)
        cand = torch.cat([boxes, gt_boxes], dim=1)
        cand_valid = torch.cat([valid, gt_mask], dim=1)
    with span("train.stage_match"):
        iou_max, iou_argmax = roi_match(cand, cand_valid, gt_boxes, gt_mask)
    with span("train.stage_sample"):
        return sample_roi_targets(
            cand,
            cand_valid,
            iou_max,
            iou_argmax,
            gt_boxes,
            gt_labels,
            pos_noise,
            neg_noise,
            num_samples=cfg.roi_samples,
            pos_quota=cfg.roi_pos_quota,
            pos_iou=nxt.iou,
            label_offset=cfg.label_offset,
            reg_std=nxt.reg_std,
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
    count_reduce: CountReduce | None = None,
    on_stage: Callable[[str, object], None] | None = None,
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
        ``post_nms_train + G`` candidate rois (a cascade's later stages
        by ``roi_samples + G``: :func:`draw_train_noise`).
      count_reduce: data parallelism: the loss's counts over the data
        group (``models/losses.py``).
      on_stage: :func:`train_targets`' marks.

    The program's spans (``utils/logging.py``): ``train.forward`` (the
    backbone and the RPN head), ``train.targets`` and its stages,
    ``train.head_loss`` (a cascade's stages inside it:
    :func:`train_losses`).

    The JAX package's slab-batched VGG stem (``train=True``) is a TPU
    layout with the same numbers; this is the plain stack.
    """
    b, canvas_h, canvas_w = images.shape[:3]
    dev = images.device
    anchors = device_anchors(model, canvas_h, canvas_w, dev)
    with span("train.forward"):
        feats = model.features(images.permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
    if noise is None:
        noise = draw_train_noise(generator, cfg, b, anchors.shape[0], gt_boxes.shape[1], dev)
    rpn_tg, roi_tg = train_targets(
        cfg, anchors, rpn_cls, rpn_reg, extents, gt_boxes, gt_labels, gt_mask, noise, on_stage
    )
    with span("train.head_loss"):
        return train_losses(
            model, cfg, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, (canvas_h, canvas_w), count_reduce,
            extents, (gt_boxes, gt_labels, gt_mask), noise,
        )


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4] xyxy in [0,1] canvas coords
    labels: torch.Tensor  # [B, D] 0-based foreground class ids (-1 pad)
    scores: torch.Tensor  # [B, D]
    valid: torch.Tensor  # [B, D]


PREDICT_STAGES = ("h2d", "backbone", "rpn_head", "propose", "roi_head", "decode", "class_nms")


@torch.no_grad()
def predict(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    images: torch.Tensor,
    extents: torch.Tensor,
    score_threshold: float | None = None,
    on_stage: Callable[[str, object], None] | None = None,
) -> Detections:
    """Test-time forward of any generation: proposals, then
    :func:`detect`: head on all rois (a cascade's stages), softmax,
    deltas un-normalised by REG_STD and decoded against the rois, clamp,
    per-class threshold + NMS, labels 0-based.

    Args:
      images: ``[B, H, W, 3]`` normalised canvas batch (the JAX package's
        layout; the network runs NCHW).
      extents: ``[B, 2]`` (w_frac, h_frac).
      on_stage: called as ``on_stage(name, result)`` as each of
        :data:`PREDICT_STAGES` ends (``h2d`` is the anchors' copy;
        ``decode`` hands over the class probabilities).

    The call is the program's span ``predict.call`` and each stage its
    child ``predict.<stage>``, ended by the stage's mark
    (``utils/logging.py``); the spans read the host clock alone: no
    device sync.
    """
    with span("predict.call"), stage_spans("predict", PREDICT_STAGES, on_stage) as mark:
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
        )
        mark("propose", props.rois)
        return detect(
            model, cfg, feats, props.rois, props.valid, (canvas_h, canvas_w), thres, mark, extents
        )


@torch.no_grad()
def detect(
    model: LegacyFRCNN | FPNFRCNN,
    cfg: DetectorConfig,
    feats,
    rois: torch.Tensor,
    valid: torch.Tensor,
    canvas_hw: tuple[int, int],
    score_threshold: float,
    on_stage: Callable[[str, object], None] | None = None,
    extents: torch.Tensor | None = None,
) -> Detections:
    """The stages of :func:`predict` after the proposals: the RoI head on
    ``rois`` ``[B, S, 4]`` (``valid`` ``[B, S]``), softmax, deltas
    un-normalised by REG_STD and decoded against the rois, clamp, and the
    per-class threshold + NMS.

    A cascade (:func:`roi_stages`) runs stage ``t`` on the boxes stage ``t
    - 1`` refined, all ``S`` rois an image, as Detectron2 does (the spans
    ``predict.stage_head`` and ``predict.refine``); its probabilities are
    the mean of the stages' softmax, and its boxes the last stage's, one a
    roi for every class, clipped to ``extents [B, 2]`` as its refined
    boxes are (the whole canvas when ``None``)."""
    mark = on_stage or (lambda name, result: None)
    b, s = rois.shape[:2]
    stages = roi_stages(cfg)
    cascade = len(stages) > 1
    stage_span = span if cascade else contextlib.nullcontext
    if extents is None:
        extents = rois.new_ones((b, 2))
    total = 0.0
    for t in range(len(stages)):
        if t:
            with span("predict.refine"):
                rois = refine_boxes(rois, head_reg, stages[t - 1].reg_std, extents)
        with stage_span("predict.stage_head"):
            head_cls, head_reg = model.head(feats, rois, canvas_hw, stage=t)
            if cascade:
                total = total + softmax(head_cls)
    mark("roi_head", head_cls)
    probs = total / len(stages) if cascade else softmax(head_cls)
    probs = torch.where(valid[:, :, None], probs, 0.0)
    if cascade:
        boxes = refine_boxes(rois, head_reg, stages[-1].reg_std, extents)
        boxes = boxes[:, :, None, :].expand(b, s, cfg.num_classes, 4)
    else:
        reg = scale_columns(head_reg.reshape(b, s, cfg.num_classes, 4), stages[0].reg_std)
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
        )
    )
    mark("class_nms", dets)
    return dets


def label_offset_for(generation: str, data_type: str) -> int:
    """Dataset label -> head class index offset: the FPN and cascade
    generations on COCO consume raw category ids (1..90, background 0),
    so they need none; every 0-based labelling (VOC, COCO remapped to
    0..79 for the legacy generation) shifts by 1 past the background
    slot."""
    return 0 if (generation in ("fpn", "cascade") and data_type == "coco") else 1


def build_model(
    generation: str,
    num_classes: int | None = None,
    label_offset: int | None = None,
    remat: bool = False,
):
    """Model + config factory (float32 parameters, uninitialised beyond
    PyTorch's defaults: load a state dict or call
    :func:`init_detector_weights`).
    ``label_offset`` overrides the config's (see :func:`label_offset_for`).
    ``remat`` (``--remat_backbone``): the backbone recomputes its
    activations in the backward, VGG16 whole and ResNet50 per
    bottleneck; the parameters are the same."""
    models = {
        "legacy": (LEGACY_CONFIG, LegacyFRCNN),
        "fpn": (FPN_CONFIG, FPNFRCNN),
        "cascade": (CASCADE_CONFIG, CascadeRCNN),
    }
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

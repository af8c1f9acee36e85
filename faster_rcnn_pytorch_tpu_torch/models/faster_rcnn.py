"""The legacy (VGG16 + RoIPool) Faster R-CNN detector and its predict.

Counterpart of ``faster_rcnn_pytorch_tpu/models/faster_rcnn.py`` for the
legacy generation. Images live on a padded canvas; box coordinates are
normalised to [0, 1] of the canvas, and each image's valid extent
(w_frac, h_frac) flows through proposal selection.

The module's parameter names are the reference legacy layout, so the
state dict from ``export_legacy_torch_state_dict`` (or a reference
``.pth.tar``) loads with ``strict=True``. That layout holds the shared
classifier twice, as ``classifier.*`` and ``fast_rcnn_head.classifier.*``:
one ``nn.Sequential`` is registered under both names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from faster_rcnn_pytorch_tpu_torch.models.anchors import legacy_anchors
from faster_rcnn_pytorch_tpu_torch.models.rpn import RPNHead, propose, softmax
from faster_rcnn_pytorch_tpu_torch.models.vgg import VGG16Features
from faster_rcnn_pytorch_tpu_torch.ops.boxes import cxcy_to_xy, decode, xy_to_cxcy
from faster_rcnn_pytorch_tpu_torch.ops.nms import multiclass_nms
from faster_rcnn_pytorch_tpu_torch.ops.roi_pool import roi_pool_batch

# Box-regression target normalisation (models/targets.py REG_STD).
REG_STD = (0.1, 0.1, 0.2, 0.2)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static hyper-parameters of one model generation (the JAX package's
    ``DetectorConfig``; the train-only fields wait for the train slice)."""

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


class FastRCNNHead(nn.Module):
    """RoI head: the shared classifier, then class scores and boxes."""

    def __init__(self, classifier: nn.Sequential, num_classes: int):
        super().__init__()
        self.classifier = classifier
        self.cls_head = nn.Linear(4096, num_classes)
        self.reg_head = nn.Linear(4096, num_classes * 4)


class LegacyFRCNN(nn.Module):
    """VGG16 Faster R-CNN: conv5_3 features at stride 16, 9-anchor RPN,
    7x7 RoIPool head with the shared 4096-wide FC trunk."""

    def __init__(self, num_classes: int = 21):
        super().__init__()
        self.num_classes = num_classes
        self.extractor = VGG16Features()
        self.rpn = RPNHead(num_anchors=9, channels=512)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096),
            nn.ReLU(inplace=True),
            nn.Linear(4096, 4096),
            nn.ReLU(inplace=True),
        )
        self.fast_rcnn_head = FastRCNNHead(self.classifier, num_classes)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, 3, H, W]`` -> ``[B, 512, H//16, W//16]``."""
        return self.extractor(images)

    def rpn_out(self, feats: torch.Tensor):
        return self.rpn(feats)

    def head(self, feats: torch.Tensor, rois: torch.Tensor, plain_roi_pool: bool = False):
        """feats ``[B, 512, h, w]``, rois ``[B, S, 4]`` in [0, 1] ->
        float32 ``([B, S, C], [B, S, 4C])``. Rois are scaled to feature
        cells before RoIPool; the ``[C, 7, 7]`` flatten meets fc6 in the
        reference layout. ``plain_roi_pool`` is for tests only."""
        b, _, fh, fw = feats.shape
        scale = torch.tensor([fw, fh, fw, fh], dtype=torch.float32, device=feats.device)
        pooled = roi_pool_batch(feats, rois * scale, 1.0, output_size=7, plain=plain_roi_pool)
        x = self.classifier(pooled.reshape(b, rois.shape[1], -1))
        head = self.fast_rcnn_head
        return head.cls_head(x).float(), head.reg_head(x).float()

    def canvas_anchors(self, height: int, width: int):
        return legacy_anchors(height, width)


def init_weights(model: LegacyFRCNN, generator: torch.Generator) -> LegacyFRCNN:
    """Seeded random init: He-normal backbone and trunk (keeps activations
    O(1) through the 15 ReLU layers), N(0, 0.01) RPN and class head,
    N(0, 0.001) box head, zero biases (the reference's head inits)."""
    small = {
        model.rpn.inter_layer: 0.01,
        model.rpn.cls_layer: 0.01,
        model.rpn.reg_layer: 0.01,
        model.fast_rcnn_head.cls_head: 0.01,
        model.fast_rcnn_head.reg_head: 0.001,
    }
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            std = small.get(m, math.sqrt(2.0 / (m.weight[0].numel())))
            w = torch.randn(m.weight.shape, generator=generator) * std
            m.weight.copy_(w)
            m.bias.zero_()
    return model


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4] xyxy in [0,1] canvas coords
    labels: torch.Tensor  # [B, D] 0-based foreground class ids (-1 pad)
    scores: torch.Tensor  # [B, D]
    valid: torch.Tensor  # [B, D]


@torch.no_grad()
def predict(
    model: LegacyFRCNN,
    cfg: DetectorConfig,
    images: torch.Tensor,
    extents: torch.Tensor,
    score_threshold: float | None = None,
    plain_roi_pool: bool = False,
) -> Detections:
    """Test-time forward: proposals, head on all rois, softmax, deltas
    un-normalised by REG_STD and decoded against the rois, clamp,
    per-class threshold + NMS, labels 0-based.

    Args:
      images: ``[B, H, W, 3]`` normalised canvas batch (the JAX package's
        layout; the network runs NCHW).
      extents: ``[B, 2]`` (w_frac, h_frac).
      plain_roi_pool: tests only; hold the kernel's path against the
        plain RoIPool.
    """
    b, canvas_h, canvas_w = images.shape[:3]
    dev = images.device
    dtype = next(model.parameters()).dtype
    anchors = torch.from_numpy(model.canvas_anchors(canvas_h, canvas_w)).to(dev)
    thres = cfg.score_threshold if score_threshold is None else score_threshold

    feats = model.features(images.permute(0, 3, 1, 2).to(dtype).contiguous())
    rpn_cls, rpn_reg = model.rpn_out(feats)
    props = [
        propose(
            rpn_cls[i],
            rpn_reg[i],
            anchors,
            extents[i],
            pre_k=cfg.pre_nms_test,
            post_k=cfg.post_nms_test,
            nms_iou=cfg.rpn_nms_iou,
            min_size=cfg.proposal_min_size,
            nms_tile=cfg.rpn_nms_tile,
        )
        for i in range(b)
    ]
    rois = torch.stack([p.rois for p in props])
    valid = torch.stack([p.valid for p in props])

    head_cls, head_reg = model.head(feats, rois, plain_roi_pool=plain_roi_pool)
    s = cfg.post_nms_test
    probs = softmax(head_cls)
    probs = torch.where(valid[:, :, None], probs, 0.0)
    reg_std = torch.tensor(REG_STD, dtype=torch.float32, device=dev)
    reg = head_reg.reshape(b, s, cfg.num_classes, 4) * reg_std
    rois_c = xy_to_cxcy(rois)[:, :, None, :]
    boxes = cxcy_to_xy(decode(reg, rois_c)).clamp(0.0, 1.0)

    outs = [
        multiclass_nms(
            boxes[i],
            probs[i],
            thres,
            cfg.nms_iou,
            num_classes=cfg.num_classes,
            per_class_k=cfg.max_detections,
            max_det=cfg.max_detections,
        )
        for i in range(b)
    ]
    return Detections(*(torch.stack(t) for t in zip(*outs)))


def build_model(generation: str, num_classes: int | None = None):
    """Model + config factory (float32 parameters, uninitialised beyond
    PyTorch's defaults: load a state dict or call :func:`init_weights`)."""
    if generation == "fpn":
        raise NotImplementedError(
            "the FPN generation is not ported yet; see ROADMAP.md Queue A"
        )
    if generation != "legacy":
        raise ValueError(f"unknown generation: {generation!r}")
    cfg = LEGACY_CONFIG
    if num_classes is not None:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    return LegacyFRCNN(num_classes=cfg.num_classes), cfg

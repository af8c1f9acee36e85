"""Plain PyTorch Cascade R-CNN R50-FPN: the train forward, the loss, its
gradients and one SGD step, and predict.

Written from Cai & Vasconcelos 2018 (arXiv:1712.00726) and mmdetection's
``configs/cascade_rcnn/cascade-rcnn_r50_fpn_1x_coco.py``: the ResNet50-FPN
trunk, RPN and proposals of ``detector.py``'s FPN generation, then three
RoI heads (MultiScaleRoIAlign 7x7, two fc layers of 1024, a class layer
and a class-agnostic 4-output box layer). Stage ``t`` labels its
candidates at IoU ``u_t`` (positive at ``>= u_t``, negative below),
samples ``roi_samples`` an image with a positive quota, the gt appended as
candidates, and encodes its targets with its own stds. The loss is the
RPN's plus ``sum_t w_t (CE_t + smoothL1_t)``. In training, the rois stage
``t`` sampled are decoded with its detached deltas, clipped to the
image's extent, and with the gt appended again are stage ``t + 1``'s
candidates. At test time each stage runs on the previous stage's boxes;
the class probabilities are the mean of the stages' softmax (as
Detectron2 computes them) and the boxes are the last stage's.

Departures from the published model, each kept so that one seeded run
compares number for number:

* the sampled slots that held a gt or padding are masked out of the next
  stage's candidates; mmdetection's ``refine_bboxes`` drops the gt rows;
* sampling ranks uniform noise drawn from a generator (a uniform random
  subset, as mmdetection's random sampler draws, in another way);
* the proposals are ``detector.py``'s FPN budgets: 4000 -> 1000 in
  training (mmdetection keeps 2000), 2000 -> 1000 at test;
* the per-class NMS at the FPN budgets' IoU 0.3 (mmdetection 0.5);
* mmdetection averages the stages' logits at test time; this averages
  their softmax, as Detectron2 does.

Every multiply is float32 with TF32 off (under the caller's autocast,
the configuration's dtype). Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from benchmark.reference import detector as d
from benchmark.reference.nets import Backbone, Head, Linear, Numerics, RPNHead, _trunk

# The largest log-scale a box delta may take: log(1000 / 16), as the
# published box coders cap it.
BOX_SCALE_CLAMP = math.log(1000.0 / 16.0)
STAGE_KEYS = ("stage_ious", "stage_reg_stds", "stage_loss_weights")


@dataclass(frozen=True)
class Stages:
    """The cascade's per-stage hyper-parameters: IoU thresholds, the
    regression stds (flat, four a stage) and the loss weights."""

    ious: tuple
    reg_stds: tuple
    loss_weights: tuple

    def std(self, t: int) -> tuple:
        return tuple(self.reg_stds[4 * t : 4 * t + 4])


def split_budgets(budgets: dict) -> tuple[d.Budgets, Stages]:
    """A configuration's ``budgets``: the one-head budgets and the stages."""
    one = {k: v for k, v in budgets.items() if k not in STAGE_KEYS}
    return d.Budgets(**one), Stages(*(tuple(budgets[k]) for k in STAGE_KEYS))


class CascadeNet(nn.Module):
    """The FPN trunk and RPN head, and one RoI head a stage. The parameter
    names are the configuration's: ``backbone``, ``rpn.rpn_head``,
    ``roi_heads.<t>.{classifier, cls_head, reg_head}``."""

    generation = "cascade"

    def __init__(self, classes: int, num: Numerics, stages: int = 3):
        super().__init__()
        self.backbone = Backbone(num)
        self.rpn = nn.ModuleDict({"rpn_head": RPNHead(3, 256, num)})
        heads = []
        for _ in range(stages):
            head = Head(_trunk(256 * 49, 1024, num), 1024, classes, num)
            head.reg_head = Linear(1024, 4, num=num)  # class-agnostic
            heads.append(head)
        self.roi_heads = nn.ModuleList(heads)

    def features(self, images):
        return self.backbone(images)

    def rpn_out(self, feats):
        outs = [self.rpn["rpn_head"](f) for f in feats]
        return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)


def build(classes: int, numerics: str = "stated") -> CascadeNet:
    return CascadeNet(classes, Numerics(numerics))


def refine(rois, reg, std, extents):
    """Boxes from deltas ``reg [..., S, 4]`` times ``std`` (log-scales
    capped at ``BOX_SCALE_CLAMP``) against ``rois``, clipped to each
    image's extent ``extents [..., 2]``."""
    t = d.scale_columns(reg, std)
    t = torch.cat([t[..., :2], t[..., 2:].clamp(max=BOX_SCALE_CLAMP)], -1)
    boxes = d.cxcy_to_xy(d.decode(t, d.xy_to_cxcy(rois)))
    hi = torch.cat([extents, extents], -1).float()
    return torch.minimum(boxes.clamp(min=0.0), hi[..., None, :])


def stage_targets(cand, cvalid, gt, labels_in, gt_mask, pos_noise, neg_noise, bud: d.Budgets,
                  pos_iou: float, std):
    """One image's ``roi_samples`` of its candidates ``cand [n, 4]`` at IoU
    threshold ``pos_iou``: the sampled rois, their class labels (0
    background, -1 unfilled), their deltas divided by ``std``, each
    sample's position among the candidates, and whether it is filled."""
    iou = torch.where(gt_mask[None, :], d.jaccard(cand, gt), -1.0)
    iou_max, iou_arg = torch.where(cvalid[:, None], iou, -1.0).max(dim=1)
    pos_mask = cvalid & (iou_max >= pos_iou)
    neg_mask = cvalid & (iou_max < pos_iou) & (iou_max >= 0.0)
    n = cand.shape[0]
    n_pos = pos_mask.sum().clamp(max=bud.roi_pos_quota)
    pos_rank = d._rank_topk(pos_noise, pos_mask, n)
    neg_rank = d._rank_topk(neg_noise, neg_mask, n)
    sel_pos = pos_rank < n_pos
    sel_neg = neg_rank < (bud.roi_samples - n_pos)
    slot = torch.where(sel_pos, pos_rank, torch.where(sel_neg, n_pos + neg_rank, n))
    idx = torch.sort(slot, stable=True)[1][: bud.roi_samples]
    taken = (sel_pos | sel_neg)[idx]
    is_pos = sel_pos[idx] & taken
    matched = iou_arg[idx]
    labels = torch.where(is_pos, labels_in[matched].to(torch.int32) + bud.label_offset, 0)
    labels = torch.where(taken, labels, -1)
    reg = d.encode(d.xy_to_cxcy(gt[matched]), d.xy_to_cxcy(cand[idx]), 1e-8)
    reg = torch.where(is_pos[:, None], reg / torch.tensor(std, device=cand.device), 0.0)
    return cand[idx], labels, reg, idx, taken


def stage_noise(generator, b: int, n_cand: int, stages: int, device):
    """The later stages' sampling noise, drawn after ``detector.draw_noise``'s
    four: for each stage after the first, uniform ``[b, n_cand]`` for its
    positives, then for its negatives."""
    return [
        tuple(torch.rand((b, n_cand), generator=generator, device=device) for _ in range(2))
        for _ in range(stages - 1)
    ]


class CascadeReference(d.Reference):
    """``detector.Reference``'s train step and SGD update over the cascade's
    loss, and the cascade's predict. ``noise`` is ``draw_noise``'s four
    tensors followed by ``stage_noise``'s pairs, flattened."""

    def __init__(self, budgets: dict, weights: dict, device, numerics="stated"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.bud, self.stages = split_budgets(budgets)
        self.net = build(self.bud.num_classes, numerics).to(device)
        params = dict(self.net.named_parameters())
        missing = set(params) ^ set(weights)
        if missing:
            raise KeyError(f"weights and the reference differ in {sorted(missing)[:5]}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])
        self.device = torch.device(device)
        self.momentum: dict = {}
        self._anchors: dict = {}
        self.load: tuple = ([], [])

    def targets(self, batch, noise, rpn_cls, rpn_reg):
        """The RPN's targets and the first stage's, per image, stacked."""
        bud = self.bud
        b, h, w = batch["image"].shape[:3]
        anchors = self.anchors(h, w)
        rois, valid = d.propose(
            rpn_cls, rpn_reg, anchors, batch["extent"], bud.pre_nms_train, bud.post_nms_train,
            bud.rpn_nms_iou, bud.proposal_min_size,
        )
        rpn_t = [
            d.rpn_targets(anchors, batch["gt_boxes"][i], batch["gt_mask"][i], batch["extent"][i],
                          noise[0][i], noise[1][i], bud)
            for i in range(b)
        ]
        return [torch.stack(t) for t in zip(*rpn_t)], self.sample(batch, rois, valid, noise[2], noise[3], 0)

    def sample(self, batch, boxes, valid, pos_noise, neg_noise, t: int):
        """Stage ``t``'s targets of the candidates ``boxes [B, n, 4]``
        (``valid [B, n]``) with the gt appended, image by image."""
        out = [
            stage_targets(torch.cat([boxes[i], batch["gt_boxes"][i]]),
                          torch.cat([valid[i], batch["gt_mask"][i]]), batch["gt_boxes"][i],
                          batch["gt_labels"][i], batch["gt_mask"][i], pos_noise[i], neg_noise[i],
                          self.bud, self.stages.ious[t], self.stages.std(t))
            for i in range(boxes.shape[0])
        ]
        return [torch.stack(x) for x in zip(*out)]

    def loss(self, batch, noise, autocast_dtype):
        """The losses ``[5]`` (total, RPN class and box, the stages'
        weighted class and box sums) of a batch."""
        net, bud, st = self.net, self.bud, self.stages
        images = batch["image"]
        b, h, w = images.shape[:3]
        n_stages = len(st.ious)
        with torch.autocast(self.device.type, dtype=autocast_dtype):
            feats = net.features(images.permute(0, 3, 1, 2).contiguous())
            rpn_cls, rpn_reg = net.rpn_out(feats)
            with torch.no_grad():
                (rpn_lab, rpn_reg_t), tg = self.targets(batch, noise, rpn_cls, rpn_reg)
            n_rois, out = bud.post_nms_train, []
            for t in range(n_stages):
                if t:
                    with torch.no_grad():
                        s_rois, _, _, idx, taken = tg
                        boxes = refine(s_rois, reg.detach(), st.std(t - 1), batch["extent"])
                        tg = self.sample(batch, boxes, taken & (idx < n_rois),
                                         noise[2 + 2 * t], noise[3 + 2 * t], t)
                        n_rois = bud.roi_samples
                cls, reg = net.roi_heads[t](d.pool(net, feats, tg[0], (h, w)))
                out.append((cls, reg, tg[1], tg[2]))
        n_rpn = (rpn_lab >= 0).sum().clamp(min=1)
        rc = d._nll_sum(rpn_cls, rpn_lab) / n_rpn
        rr = torch.where(rpn_lab > 0, d._smooth_l1(rpn_reg - rpn_reg_t, 1 / 9).sum(-1), 0.0).sum() / n_rpn
        fc = fr = 0.0
        for wt, (cls, reg, lab, reg_t) in zip(st.loss_weights, out):
            n = (lab >= 0).sum().clamp(min=1)
            fc = fc + wt * (d._nll_sum(cls, lab) / n)
            fr = fr + wt * (torch.where(lab > 0, d._smooth_l1(reg - reg_t, 1.0).sum(-1), 0.0).sum() / n)
        return torch.stack([rc + rr + fc + fr, rc, rr, fc, fr])

    @torch.no_grad()
    def predict(self, images, extents, dtype=torch.bfloat16):
        """Detections of a batch, as ``detector.Reference.predict`` gives
        them: the mean of the stages' softmax, the last stage's boxes for
        every class."""
        net, bud, st = self.net, self.bud, self.stages
        for p in net.parameters():
            p.data = p.data.to(dtype)
        b, h, w = images.shape[:3]
        feats = net.features(images.permute(0, 3, 1, 2).to(dtype).contiguous())
        rpn_cls, rpn_reg = net.rpn_out(feats)
        boxes, valid = d.propose(
            rpn_cls, rpn_reg, self.anchors(h, w), extents, bud.pre_nms_test, bud.post_nms_test,
            bud.rpn_nms_iou, bud.proposal_min_size,
        )
        total = 0.0
        for t in range(len(st.ious)):
            if t:
                boxes = refine(boxes, reg, st.std(t - 1), extents)
            cls, reg = net.roi_heads[t](d.pool(net, feats, boxes, (h, w)))
            total = total + d.softmax(cls)
        probs = torch.where(valid[:, :, None], total / len(st.ious), 0.0)
        final = refine(boxes, reg, st.std(len(st.ious) - 1), extents)
        s = final.shape[1]
        per_class = final[:, :, None, :].expand(b, s, bud.num_classes, 4)
        dets = [d.class_nms(per_class[i], probs[i], bud) for i in range(b)]
        self.load[0].extend((probs[:, :, 1:] > bud.score_threshold).sum(dim=(1, 2)).tolist())
        self.load[1].extend(len(x[2]) for x in dets)
        return dets

"""Plain PyTorch Faster R-CNN: anchors, proposals, exact greedy NMS, the
train targets, RoIPool and MultiScaleRoIAlign, the four-part loss, one
SGD step, and predict with per-class NMS.

Straightforward tensor code with host synchronisations where they make
it simpler (the NMS sweep). It follows the published method and the
reference implementation's conventions (boxes normalised to the padded
canvas; sampling by ranking uniform noise drawn from a generator; ties to
the lowest index). It imports nothing of the program under test and takes
nothing the program made: the caller hands it the seeded weights, the
images and boxes, and a generator seeded like the one the program is
handed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.nets import build

REG_STD = (0.1, 0.1, 0.2, 0.2)


@dataclass(frozen=True)
class Budgets:
    """One generation's static hyper-parameters (the configuration file's
    ``budgets``)."""

    num_classes: int
    pre_nms_train: int
    post_nms_train: int
    pre_nms_test: int
    post_nms_test: int
    rpn_nms_iou: float
    proposal_min_size: float
    roi_samples: int
    roi_pos_quota: int
    roi_pos_iou: float
    label_offset: int
    rpn_pos_iou: float
    rpn_neg_iou: float
    rpn_pos_quota: int
    rpn_total_quota: int
    rpn_allow_ties: bool
    rpn_boundary_filter: bool
    score_threshold: float
    nms_iou: float
    max_detections: int


# ---------------------------------------------------------------- anchors


def legacy_anchors(height: int, width: int) -> np.ndarray:
    """Base 16, scales (8, 16, 32), ratios (0.5, 1, 2), centred at 8 px,
    stride 16; (y, x, ratio, scale) order; normalised xyxy."""
    base = []
    for r in (0.5, 1.0, 2.0):
        for s in (8, 16, 32):
            w, h = 16 * s * np.sqrt(r), 16 * s * np.sqrt(1.0 / r)
            base.append((8.0 - w / 2.0, 8.0 - h / 2.0, 8.0 + w / 2.0, 8.0 + h / 2.0))
    base = np.asarray(base, np.float32)
    sx, sy = np.meshgrid(
        np.arange(width // 16, dtype=np.float32) * 16, np.arange(height // 16, dtype=np.float32) * 16
    )
    shift = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    out = (base[None] + shift[:, None]).reshape(-1, 4)
    out /= np.array([width, height, width, height], np.float32)
    return out.astype(np.float32)


def fpn_anchors(height: int, width: int) -> np.ndarray:
    """One size a level (32..512 px at strides 4..64), ratios (0.5, 1, 2),
    rounded cell anchors on the cell origin; (level, y, x, anchor) order."""
    out = []
    for stride, size in zip((4, 8, 16, 32, 64), (32, 64, 128, 256, 512)):
        hr = np.sqrt(np.asarray((0.5, 1.0, 2.0), np.float32))
        ws, hs = size / hr, hr * size
        base = np.round(np.stack([-ws, -hs, ws, hs], 1) / 2.0).astype(np.float32)
        gx, gy = np.meshgrid(
            np.arange(-(-width // stride), dtype=np.float32) * stride,
            np.arange(-(-height // stride), dtype=np.float32) * stride,
        )
        shift = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], 1)
        out.append((shift[:, None] + base[None]).reshape(-1, 4))
    out = np.concatenate(out) / np.array([width, height, width, height], np.float32)
    return out.astype(np.float32)


# ----------------------------------------------------------------- boxes


def cxcy_to_xy(c):
    return torch.cat([c[..., :2] - c[..., 2:] / 2.0, c[..., :2] + c[..., 2:] / 2.0], -1)


def xy_to_cxcy(x):
    return torch.cat([(x[..., 2:] + x[..., :2]) / 2.0, x[..., 2:] - x[..., :2]], -1)


def decode(t, anc):
    return torch.cat([t[..., :2] * anc[..., 2:] + anc[..., :2], torch.exp(t[..., 2:]) * anc[..., 2:]], -1)


def encode(gt, anc, eps):
    a_wh = anc[..., 2:].clamp(min=eps)
    return torch.cat(
        [(gt[..., :2] - anc[..., :2]) / a_wh, torch.log(gt[..., 2:].clamp(min=eps) / a_wh)], -1
    )


def _inter(a, b):
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (hi - lo).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def _area(x):
    return (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])


def jaccard(a, b, eps=1e-5):
    """IoU with an epsilon on the union (the train targets)."""
    inter = _inter(a, b)
    return inter / (_area(a)[..., :, None] + _area(b)[..., None, :] - inter + eps)


def box_iou(a, b):
    """IoU with the union floored at 1e-12 (the NMS)."""
    inter = _inter(a, b)
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def softmax(x, dim=-1):
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def scale_columns(x, factors):
    return torch.stack([x[..., i] * f for i, f in enumerate(factors)], dim=-1)


# ------------------------------------------------------------------- NMS


def greedy_nms(boxes, valid, iou_threshold: float, post_k: int, tile: int = 256):
    """Exact greedy NMS over score-sorted ``boxes [n, 4]``: positions of the
    first ``post_k`` kept boxes, in order. A box is dropped when its IoU
    with a kept box of higher score exceeds the threshold. Tiles of boxes
    are suppressed by the kept boxes before them, then iterated to their
    own greedy fixpoint."""
    n = boxes.shape[0]
    boxes = boxes.float()
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    count = 0
    for s in range(0, n, tile):
        if count >= post_k:
            break
        rows = boxes[s : s + tile]
        active0 = valid[s : s + tile]
        if not bool(active0.any()):
            continue
        if s:
            over_kept = (box_iou(rows, boxes[:s]) > iou_threshold) & keep[None, :s]
            active0 = active0 & ~over_kept.any(dim=1)
        over = torch.triu(box_iou(rows, rows) > iou_threshold, diagonal=1)
        active = active0
        while True:
            new = active0 & ~(active[:, None] & over).any(dim=0)
            if torch.equal(new, active):
                break
            active = new
        keep[s : s + tile] = active
        count += int(active.sum())
    return torch.nonzero(keep).flatten()[:post_k]


def propose(rpn_cls, rpn_reg, anchors, extents, pre_k, post_k, nms_iou, min_size):
    """``post_k`` proposals an image: foreground softmax, deltas decoded on
    the anchors and clipped to the image's extent, boxes under
    ``min_size`` dropped, the top ``pre_k`` by score (stable), NMS."""
    b = rpn_cls.shape[0]
    fg = softmax(rpn_cls)[..., 1]
    boxes = cxcy_to_xy(decode(rpn_reg, xy_to_cxcy(anchors)))
    hi = torch.cat([extents, extents], -1).float()
    boxes = torch.minimum(boxes.clamp(min=0.0), hi[:, None, :])
    ok = ((boxes[..., 2] - boxes[..., 0]) >= min_size) & ((boxes[..., 3] - boxes[..., 1]) >= min_size)
    score = torch.where(ok, fg, float("-inf"))
    vals, order = torch.sort(score, dim=-1, descending=True, stable=True)
    k = min(pre_k, score.shape[1])
    rois = torch.zeros((b, post_k, 4), device=boxes.device)
    valid = torch.zeros((b, post_k), dtype=torch.bool, device=boxes.device)
    for i in range(b):
        cand = boxes[i][order[i, :k]]
        kept = greedy_nms(cand, vals[i, :k] > float("-inf"), nms_iou, post_k)
        rois[i, : kept.numel()] = cand[kept]
        valid[i, : kept.numel()] = True
    return rois, valid


# --------------------------------------------------------------- targets


def _rank_topk(noise, mask, k: int):
    """Rank of each member of ``mask`` by descending noise (ties to the
    lower index), exact below ``k``; ``n`` elsewhere."""
    n = noise.shape[0]
    key = torch.where(mask, noise, float("-inf"))
    _, order = torch.sort(key, descending=True, stable=True)
    rank = torch.full((n,), n, dtype=torch.int64, device=noise.device)
    k = min(k, n)
    rank[order[:k]] = torch.arange(k, device=noise.device)
    return torch.where(mask, rank, n)


def rpn_targets(anchors, gt, gt_mask, extent, pos_noise, neg_noise, bud: Budgets):
    """One image's anchor labels (-1 ignore, 0, 1) and deltas."""
    a = anchors.shape[0]
    if bud.rpn_boundary_filter:
        inside = (
            (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
            & (anchors[:, 2] <= extent[0]) & (anchors[:, 3] <= extent[1])
        )
    else:
        inside = torch.ones(a, dtype=torch.bool, device=anchors.device)
    iou = torch.where(gt_mask[:, None], jaccard(gt, anchors), -1.0)  # [G, A]
    iou = torch.where(inside[None, :], iou, -1.0)
    iou_max, iou_arg = iou.max(dim=0)
    per_gt_max, per_gt_arg = iou.max(dim=1)
    real = gt_mask & (per_gt_max > -1.0)
    if bud.rpn_allow_ties:
        best = ((iou == per_gt_max[:, None]) & real[:, None]).any(dim=0)
    else:
        best = torch.zeros(a, dtype=torch.bool, device=anchors.device)
        best[per_gt_arg[real]] = True
    del iou
    labels = torch.full((a,), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(inside & (iou_max < bud.rpn_neg_iou) & (iou_max >= 0.0), 0, labels)
    labels = torch.where(best & inside, 1, labels)
    labels = torch.where(inside & (iou_max >= bud.rpn_pos_iou), 1, labels)
    pos = labels == 1
    pos_rank = _rank_topk(pos_noise, pos, bud.rpn_pos_quota)
    labels = torch.where(pos & (pos_rank >= bud.rpn_pos_quota), -1, labels)
    n_pos = pos.sum().clamp(max=bud.rpn_pos_quota)
    neg = labels == 0
    neg_rank = _rank_topk(neg_noise, neg, bud.rpn_total_quota)
    labels = torch.where(neg & (neg_rank >= bud.rpn_total_quota - n_pos), -1, labels)

    m = gt[torch.where(gt_mask.any(), iou_arg, 0)]
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-8)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-8)
    p = labels == 1
    tx = torch.where(p, ((m[:, 0] + m[:, 2]) / 2.0 - (anchors[:, 0] + anchors[:, 2]) / 2.0) / aw, 0.0)
    ty = torch.where(p, ((m[:, 1] + m[:, 3]) / 2.0 - (anchors[:, 1] + anchors[:, 3]) / 2.0) / ah, 0.0)
    tw = torch.where(p, torch.log((m[:, 2] - m[:, 0]).clamp(min=1e-8) / aw), 0.0)
    th = torch.where(p, torch.log((m[:, 3] - m[:, 1]).clamp(min=1e-8) / ah), 0.0)
    return labels, torch.stack([tx, ty, tw, th], -1)


def roi_targets(rois, roi_valid, gt, labels_in, gt_mask, pos_noise, neg_noise, bud: Budgets):
    """One image's ``roi_samples`` rois (the gt appended as candidates),
    their class labels (0 background, -1 unfilled) and normalised deltas."""
    cand = torch.cat([rois, gt], 0)
    cvalid = torch.cat([roi_valid, gt_mask], 0)
    iou = torch.where(gt_mask[None, :], jaccard(cand, gt), -1.0)
    iou_max, iou_arg = torch.where(cvalid[:, None], iou, -1.0).max(dim=1)
    pos_mask = cvalid & (iou_max >= bud.roi_pos_iou)
    neg_mask = cvalid & (iou_max < bud.roi_pos_iou) & (iou_max >= 0.0)
    n = cand.shape[0]
    n_pos = pos_mask.sum().clamp(max=bud.roi_pos_quota)
    pos_rank = _rank_topk(pos_noise, pos_mask, n)
    neg_rank = _rank_topk(neg_noise, neg_mask, n)
    sel_pos = pos_rank < n_pos
    sel_neg = neg_rank < (bud.roi_samples - n_pos)
    slot = torch.where(sel_pos, pos_rank, torch.where(sel_neg, n_pos + neg_rank, n))
    idx = torch.sort(slot, stable=True)[1][: bud.roi_samples]
    taken = (sel_pos | sel_neg)[idx]
    is_pos = sel_pos[idx] & taken
    matched = iou_arg[idx]
    labels = torch.where(is_pos, labels_in[matched].to(torch.int32) + bud.label_offset, 0)
    labels = torch.where(taken, labels, -1)
    std = torch.tensor(REG_STD, device=cand.device)
    reg = encode(xy_to_cxcy(gt[matched]), xy_to_cxcy(cand[idx]), 1e-8)
    reg = torch.where(is_pos[:, None], reg / std, 0.0)
    return cand[idx], labels, reg


# -------------------------------------------------------------- RoI ops


def _bins(start, extent, size, p=7):
    q = torch.arange(p, dtype=torch.int64, device=start.device)
    lo = (q[None] * extent[:, None]) // p
    hi = ((q[None] + 1) * extent[:, None] + p - 1) // p
    return (lo + start[:, None]).clamp(0, size), (hi + start[:, None]).clamp(0, size)


class RoIPool(torch.autograd.Function):
    """Max over each of the 7x7 bins of rounded roi corners (in feature
    cells); the backward sends each bin's gradient to its first maximum."""

    @staticmethod
    def forward(ctx, feats, rois, chunk: int = 32):
        b, c, h, w = feats.shape
        n = rois.shape[1]
        dev = feats.device
        corners = torch.round(rois.reshape(-1, 4).float()).to(torch.int64)
        sx, sy, ex, ey = corners.unbind(-1)
        h_lo, h_hi = _bins(sy, (ey - sy + 1).clamp(min=1), h)
        w_lo, w_hi = _bins(sx, (ex - sx + 1).clamp(min=1), w)
        k_h = max(int((h_hi - h_lo).max()), 1)
        k_w = max(int((w_hi - w_lo).max()), 1)
        rows = h_lo[:, :, None] + torch.arange(k_h, device=dev)  # [R, 7, kh]
        row_ok = rows < h_hi[:, :, None]
        cols = w_lo[:, :, None] + torch.arange(k_w, device=dev)  # [R, 7, kw]
        col_ok = cols < w_hi[:, :, None]
        rows, cols = rows.clamp(max=h - 1), cols.clamp(max=w - 1)
        image = torch.arange(b, device=dev).repeat_interleave(n)
        # a window position outside its bin reads the -inf row past the map
        cells = torch.cat([feats.float().permute(0, 2, 3, 1).reshape(b * h * w, c),
                           torch.full((1, c), float("-inf"), device=dev)])
        out = torch.zeros((b * n, 7, 7, c), device=dev)
        arg = torch.full((b * n, 7, 7, c), -1, dtype=torch.int64, device=dev)
        for s in range(0, b * n, chunk):
            sl = slice(s, s + chunk)
            r_idx = rows[sl][:, :, None, :, None]
            c_idx = cols[sl][:, None, :, None, :]
            ok = row_ok[sl][:, :, None, :, None] & col_ok[sl][:, None, :, None, :]
            cell = (image[sl][:, None, None, None, None] * h + r_idx) * w + c_idx
            win = cells[torch.where(ok, cell, b * h * w)]  # [r, 7, 7, kh, kw, C]
            r = win.shape[0]
            win = win.reshape(r, 7, 7, k_h * k_w, c)
            vals = win.amax(dim=3)
            empty = ~ok.reshape(r, 7, 7, -1).any(-1)
            out[sl] = torch.where(empty[..., None], 0.0, vals)
            pos = (r_idx * w + c_idx).expand(r, 7, 7, k_h, k_w).reshape(r, 7, 7, -1, 1)
            hit = ok.reshape(r, 7, 7, -1, 1) & (win == vals[:, :, :, None])
            first = torch.where(hit, pos, torch.iinfo(torch.int64).max).amin(dim=3)
            arg[sl] = torch.where(empty[..., None], -1, first)
        ctx.save_for_backward(arg)
        ctx.shape = (b, c, h, w)
        ctx.dtype = feats.dtype
        return out.permute(0, 3, 1, 2).reshape(b, n, c, 7, 7).to(feats.dtype)

    @staticmethod
    def backward(ctx, grad):
        (arg,) = ctx.saved_tensors
        b, c, h, w = ctx.shape
        n = grad.shape[1]
        g = grad.float().reshape(b * n, c, 7, 7).permute(0, 2, 3, 1).reshape(b, -1, c)
        a = arg.reshape(b, -1, c)
        a = torch.where(a >= 0, a, h * w)
        d = torch.zeros((b, h * w + 1, c), device=grad.device)
        d.scatter_add_(1, a, g)
        return d[:, : h * w].permute(0, 2, 1).reshape(b, c, h, w).to(ctx.dtype), None


def fpn_levels(rois):
    area = (rois[..., 2] - rois[..., 0]).clamp(min=0) * (rois[..., 3] - rois[..., 1]).clamp(min=0)
    return (torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-6)).clamp(2, 5) - 2).long()


def _samples(lo_edge, hi_edge, scale, size):
    """Per axis: two samples a bin at (k + 0.5) / 2 of the bin, their low
    and high cells and bilinear weights (zero outside [-1, size])."""
    start = lo_edge * scale
    extent = torch.clamp(hi_edge * scale - start, min=1.0)
    bin_size = extent / torch.full_like(extent, 7.0)
    p = torch.arange(7, dtype=torch.float32, device=lo_edge.device)
    sub = torch.arange(2, dtype=torch.float32, device=lo_edge.device)
    bs = bin_size[:, None, None]
    coords = start[:, None, None] + (p[None, :, None] * bs + (sub[None, None, :] + 0.5) * bs / 2)
    valid = (coords >= -1.0) & (coords <= size)
    c = coords.clamp(min=0.0)
    low = torch.floor(c).long()
    collapse = low >= size - 1
    low = torch.where(collapse, size - 1, low)
    high = torch.where(collapse, low, low + 1)
    c = torch.where(collapse, low.float(), c)
    frac = c - low.float()
    return low, high, torch.where(valid, 1.0 - frac, 0.0), torch.where(valid, frac, 0.0)


def roi_align(feats, rois, chunk: int = 64):
    """MultiScaleRoIAlign 7x7 over P2..P5 (strides 4..32), sampling ratio
    2, rois in canvas pixels; differentiable in the maps by autograd."""
    b, n = rois.shape[:2]
    c = feats[0].shape[1]
    flat = rois.reshape(b * n, 4).float()
    level = fpn_levels(flat)
    image = torch.arange(b, device=rois.device).repeat_interleave(n)
    parts, order = [], []
    for li, (f, stride) in enumerate(zip(feats[:4], (4, 8, 16, 32))):
        h, w = f.shape[-2:]
        nhwc = f.float().permute(0, 2, 3, 1)
        idx = torch.nonzero(level == li).flatten()
        for s in range(0, idx.numel(), chunk):
            sel = idx[s : s + chunk]
            r = flat[sel]
            ylo, yhi, wylo, wyhi = _samples(r[:, 1], r[:, 3], 1.0 / stride, h)
            xlo, xhi, wxlo, wxhi = _samples(r[:, 0], r[:, 2], 1.0 / stride, w)
            im = image[sel][:, None, None, None, None]

            def g(ys, xs):
                return nhwc[im, ys[:, :, :, None, None], xs[:, None, None, :, :]]

            def wt(wy, wx):
                return (wy[:, :, :, None, None] * wx[:, None, None, :, :])[..., None]

            v = wt(wylo, wxlo) * g(ylo, xlo)
            v = v + wt(wylo, wxhi) * g(ylo, xhi)
            v = v + wt(wyhi, wxlo) * g(yhi, xlo)
            v = v + wt(wyhi, wxhi) * g(yhi, xhi)
            acc = v[:, :, 0, :, 0] + v[:, :, 0, :, 1]
            acc = acc + v[:, :, 1, :, 0]
            acc = acc + v[:, :, 1, :, 1]
            parts.append((acc / 4).permute(0, 3, 1, 2))
            order.append(sel)
    out = torch.cat(parts)[torch.argsort(torch.cat(order))]
    return out.reshape(b, n, c, 7, 7).to(feats[0].dtype)


def pool(net, feats, rois, canvas_hw):
    h, w = canvas_hw
    if net.generation == "legacy":
        fh, fw = feats.shape[-2:]
        return RoIPool.apply(feats, scale_columns(rois, (fw, fh, fw, fh)))
    return roi_align(feats, scale_columns(rois, (w, h, w, h)))


# ------------------------------------------------------------------ loss


def _smooth_l1(x, beta):
    x = x.abs()
    return torch.where(x >= beta, x - 0.5 * beta, 0.5 * x * x / beta)


def _nll_sum(logits, labels):
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    return torch.where(labels >= 0, nll, 0.0).sum()


def losses(rpn_cls, rpn_reg, head_cls, head_reg, rpn_lab, rpn_reg_t, roi_lab, roi_reg_t):
    """Cross-entropy over the non-ignored entries and smooth L1 over the
    positives (beta 1/9 for the RPN, 1 for the head), each divided by the
    non-ignored count; ``(total, rpn_cls, rpn_reg, roi_cls, roi_reg)``."""
    n_rpn = (rpn_lab >= 0).sum().clamp(min=1)
    n_roi = (roi_lab >= 0).sum().clamp(min=1)
    rc = _nll_sum(rpn_cls, rpn_lab) / n_rpn
    rr = torch.where(rpn_lab > 0, _smooth_l1(rpn_reg - rpn_reg_t, 1 / 9).sum(-1), 0.0).sum() / n_rpn
    fc = _nll_sum(head_cls, roi_lab) / n_roi
    fr = torch.where(roi_lab > 0, _smooth_l1(head_reg - roi_reg_t, 1.0).sum(-1), 0.0).sum() / n_roi
    return torch.stack([rc + rr + fc + fr, rc, rr, fc, fr])


# ----------------------------------------------------------------- model


class Reference:
    """A plain detector on ``device`` with the given weights: ``train_step``
    (bfloat16 autocast over float32 weights, SGD with momentum and weight
    decay) and ``predict`` (weights cast to the serving dtype)."""

    def __init__(self, generation, bud: Budgets, weights: dict, device, numerics="stated"):
        self.bud = bud
        self.net = build(generation, bud.num_classes, numerics).to(device)
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
        self.load: tuple = ([], [])  # predict: class NMS candidates and kept, per image

    def anchors(self, h, w):
        if (h, w) not in self._anchors:
            make = legacy_anchors if self.net.generation == "legacy" else fpn_anchors
            self._anchors[(h, w)] = torch.from_numpy(make(h, w)).to(self.device)
        return self._anchors[(h, w)]

    def params(self):
        return dict(self.net.named_parameters())

    def loss(self, batch, noise, autocast_dtype):
        """The losses ``[5]`` of a batch (tensors on the device; the noise
        ``(rpn_pos, rpn_neg, roi_pos, roi_neg)`` rows of the batch)."""
        net, bud = self.net, self.bud
        images = batch["image"]
        b, h, w = images.shape[:3]
        anchors = self.anchors(h, w)
        with torch.autocast(self.device.type, dtype=autocast_dtype):
            feats = net.features(images.permute(0, 3, 1, 2).contiguous())
            rpn_cls, rpn_reg = net.rpn_out(feats)
            with torch.no_grad():
                rois, valid = propose(
                    rpn_cls, rpn_reg, anchors, batch["extent"], bud.pre_nms_train,
                    bud.post_nms_train, bud.rpn_nms_iou, bud.proposal_min_size,
                )
                rpn_t = [
                    rpn_targets(anchors, batch["gt_boxes"][i], batch["gt_mask"][i],
                                batch["extent"][i], noise[0][i], noise[1][i], bud)
                    for i in range(b)
                ]
                roi_t = [
                    roi_targets(rois[i], valid[i], batch["gt_boxes"][i], batch["gt_labels"][i],
                                batch["gt_mask"][i], noise[2][i], noise[3][i], bud)
                    for i in range(b)
                ]
            rpn_lab, rpn_reg_t = (torch.stack(t) for t in zip(*rpn_t))
            s_rois, roi_lab, roi_reg_t = (torch.stack(t) for t in zip(*roi_t))
            head_cls, head_reg = net.head(pool(net, feats, s_rois, (h, w)))
            s = s_rois.shape[1]
            head_reg = head_reg.reshape(b, s, bud.num_classes, 4)
            safe = roi_lab.clamp(0, bud.num_classes - 1).long()
            head_reg = head_reg.gather(2, safe[:, :, None, None].expand(b, s, 1, 4))[:, :, 0]
            return losses(rpn_cls, rpn_reg, head_cls, head_reg, rpn_lab, rpn_reg_t, roi_lab, roi_reg_t)

    def train_step(self, batch, noise, lr, momentum, weight_decay, autocast_dtype=torch.bfloat16):
        """Forward, backward and one SGD update in place; returns the
        losses ``[5]`` and each parameter's update direction (gradient
        plus weight decay) before momentum."""
        params = self.params()
        for p in params.values():
            p.grad = None
        out = self.loss(batch, noise, autocast_dtype)
        out[0].backward()
        directions = {}
        with torch.no_grad():
            for name, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                d = g + weight_decay * p
                directions[name] = d
                buf = self.momentum.get(name)
                buf = d.clone() if buf is None else buf.mul_(momentum).add_(d)
                self.momentum[name] = buf
                p.add_(buf, alpha=-lr)
        return out.detach(), directions

    @torch.no_grad()
    def predict(self, images, extents, dtype=torch.bfloat16):
        """Detections of a batch: ``(boxes [B, D, 4], labels [B, D] 0-based,
        scores [B, D])`` as lists per image, ``D <= max_detections``."""
        net, bud = self.net, self.bud
        for p in net.parameters():
            p.data = p.data.to(dtype)
        b, h, w = images.shape[:3]
        anchors = self.anchors(h, w)
        feats = net.features(images.permute(0, 3, 1, 2).to(dtype).contiguous())
        rpn_cls, rpn_reg = net.rpn_out(feats)
        rois, valid = propose(
            rpn_cls, rpn_reg, anchors, extents, bud.pre_nms_test, bud.post_nms_test,
            bud.rpn_nms_iou, bud.proposal_min_size,
        )
        head_cls, head_reg = net.head(pool(net, feats, rois, (h, w)))
        probs = torch.where(valid[:, :, None], softmax(head_cls), 0.0)
        s = rois.shape[1]
        reg = scale_columns(head_reg.reshape(b, s, bud.num_classes, 4), REG_STD)
        boxes = cxcy_to_xy(decode(reg, xy_to_cxcy(rois)[:, :, None, :])).clamp(0.0, 1.0)
        dets = [class_nms(boxes[i], probs[i], bud) for i in range(b)]
        self.load[0].extend((probs[:, :, 1:] > bud.score_threshold).sum(dim=(1, 2)).tolist())
        self.load[1].extend(len(d[2]) for d in dets)
        return dets


def class_nms(boxes, probs, bud: Budgets):
    """Per foreground class: the boxes above the score threshold, greedy
    NMS in descending score order; then the ``max_detections`` best of
    all classes by score. ``boxes [n, C, 4]``, ``probs [n, C]``."""
    kept_boxes, kept_scores, kept_labels = [], [], []
    for c in range(1, bud.num_classes):
        sc = probs[:, c]
        cand = torch.nonzero(sc > bud.score_threshold).flatten()
        if cand.numel() == 0:
            continue
        vals, order = torch.sort(sc[cand], descending=True, stable=True)
        cb = boxes[cand[order], c]
        keep = greedy_nms(cb, torch.ones_like(vals, dtype=torch.bool), bud.nms_iou, bud.max_detections)
        kept_boxes.append(cb[keep])
        kept_scores.append(vals[keep])
        kept_labels.append(torch.full((keep.numel(),), c - 1, device=boxes.device))
    if not kept_scores:
        z = boxes.new_zeros((0,))
        return boxes.new_zeros((0, 4)), z.long(), z
    scores = torch.cat(kept_scores)
    top, idx = torch.sort(scores, descending=True, stable=True)
    idx = idx[: bud.max_detections]
    return torch.cat(kept_boxes)[idx], torch.cat(kept_labels)[idx], scores[idx]


def draw_noise(generator, b, n_anchors, n_cand, device):
    """The sampling noise of a batch, drawn as the train step draws it from
    the generator it is handed: uniform ``[b, A]`` twice, then ``[b,
    post_nms_train + G]`` twice."""
    def u(n):
        return torch.rand((b, n), generator=generator, device=device)

    return u(n_anchors), u(n_anchors), u(n_cand), u(n_cand)


def anchor_count(generation: str, h: int, w: int) -> int:
    if generation == "legacy":
        return (h // 16) * (w // 16) * 9
    return sum(3 * math.ceil(h / s) * math.ceil(w / s) for s in (4, 8, 16, 32, 64))

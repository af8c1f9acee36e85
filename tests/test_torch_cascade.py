"""Cascade R-CNN R50-FPN (``build_model("cascade")``) against the plain
reference ``benchmark/reference/cascade.py`` on the CPU, float32, small
canvas, seeded random weights (the fixtures' ``init_weights``).

* One train step through ``make_train_step``: the loss, each leaf's
  update direction (gradient plus weight decay, from the momentum) and
  the SGD update against the reference's.
* Each stage's targets from the same deltas: labels, sampled rois,
  regression targets, and which slots held a gt or padding.
* Predict: the same detections (class, IoU >= 0.9) and scores.
* The later stages sample only valid rows, also for an image without gt
  and with more positives than the quota.
* A cascade that skipped the refinement (stage t + 1 on stage t's input
  boxes) is caught.
* The legacy and FPN generations take the defaults of the new arguments.
* A data-parallel rank's noise is its rows of the global draw, the
  later stages' too; the loss weights each stage over its own count.
* ``main --model_generation cascade`` trains, evaluates and saves.

The reference takes the port's proposals (``shared_proposals``): at
random weights the RPN's foreground scores sit near 0.5, thousands of
them within a few float32 ulps of each other, and two float32
convolution paths that part in the last bit (which one the CPU library
takes can change from run to run) would reorder NMS's candidates.
Everything after the proposals each side computes itself.

Tolerances, each with its reason: the CPU paths are the kernels' plain
twins and the reference's plain ops in the same float32, so targets are
exact (integer labels and indices) or within 1e-6 (boxes and deltas
through the same formulas); losses within 1e-5 relative and directions
within 1e-4 of the leaf's largest entry, because the two sides sum the
RoI align's backward and the matmuls' products in other orders; scores
within 1e-5 (softmax means of those heads).
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib import compare
from benchmark.reference import cascade as rc
from benchmark.reference import detector as rd
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models import targets as pt
from faster_rcnn_pytorch_tpu_torch.parallel import train_step as pts

CANVAS = (128, 160)
NUM_CLASSES = 6
KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")
LR, MOMENTUM, WD = 2e-3, 0.9, 1e-4


def budgets(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(rd.Budgets)}
    return dict(out, **{k: getattr(cfg, k) for k in rc.STAGE_KEYS})


def make_batch(reals=(4, 2), slots=6, seed=0):
    rs = np.random.RandomState(seed)
    b = len(reals)
    h, w = CANVAS
    gt = np.zeros((b, slots, 4), np.float32)
    mask = np.zeros((b, slots), bool)
    for i, k in enumerate(reals):
        xy = rs.uniform(0.05, 0.35, size=(k, 2))
        wh = rs.uniform(0.3, 0.55, size=(k, 2))
        gt[i, :k] = np.concatenate([xy, np.minimum(xy + wh, 0.84)], -1)
        mask[i, :k] = True
    values = (
        rs.normal(size=(b, h, w, 3)).astype(np.float32),
        np.array([[1.0, 1.0], [0.9, 0.85]] * b, np.float32)[:b],
        gt,
        rs.randint(1, NUM_CLASSES, size=(b, slots)).astype(np.int32),
        mask,
    )
    return {k: torch.from_numpy(v) for k, v in zip(KEYS, values)}


def make_model(seed=0):
    model, cfg = pfr.build_model("cascade", num_classes=NUM_CLASSES)
    pfr.init_weights(model, torch.Generator().manual_seed(seed))
    return model, cfg


def reference_noise(gen, cfg, batch):
    b, h, w = batch["image"].shape[:3]
    g = batch["gt_boxes"].shape[1]
    noise = rd.draw_noise(gen, b, rd.anchor_count("fpn", h, w), cfg.post_nms_train + g, "cpu")
    later = rc.stage_noise(gen, b, cfg.roi_samples + g, len(cfg.stage_ious), "cpu")
    return (*noise, *(t for pair in later for t in pair))


@contextlib.contextmanager
def shared_proposals():
    """The reference's ``propose`` returns, call by call, what the port's
    ``propose_batch`` returned (module docstring)."""
    made = []
    propose_batch = pfr.propose_batch

    def record(*args, **kwargs):
        made.append(propose_batch(*args, **kwargs))
        return made[-1]

    def replay(*args, **kwargs):
        props = made.pop(0)
        return props.rois, props.valid

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pfr, "propose_batch", record)
        mp.setattr(rd, "propose", replay)
        yield


def port_step(model, cfg, batch, seed=1):
    state = pts.init_train_state(model, pts.make_optimizer(model, MOMENTUM, WD))
    step_fn = pts.make_train_step(cfg, pts.make_lr_schedule("constant", LR, 1, 1))
    metrics = step_fn(state, batch, torch.Generator().manual_seed(seed))
    directions = {n: state.optimizer.state[p]["momentum_buffer"] for n, p in model.named_parameters()}
    return metrics, directions


def reference_step(weights, cfg, batch, seed=1):
    ref = rc.CascadeReference(budgets(cfg), weights, "cpu")
    noise = reference_noise(torch.Generator().manual_seed(seed), cfg, batch)
    losses, directions = ref.train_step(batch, noise, LR, MOMENTUM, WD, torch.float32)
    return ref, losses, directions


@pytest.fixture(scope="module")
def stepped():
    model, cfg = make_model()
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = make_batch()
    with shared_proposals():
        metrics, directions = port_step(model, cfg, batch)
        ref, losses, ref_dirs = reference_step(weights, cfg, batch)
    return model, metrics, directions, ref, losses, ref_dirs


def test_train_step_loss_matches_the_reference(stepped):
    _, metrics, _, _, losses, _ = stepped
    names = ("loss", "rpn_cls", "rpn_reg", "roi_cls", "roi_reg")
    for name, want in zip(names, losses.tolist()):
        assert float(metrics[name]) == pytest.approx(want, rel=1e-5, abs=1e-7), name
    assert float(metrics["roi_reg"]) > 0 and float(metrics["num_pos_roi"]) > 0


def test_each_leafs_direction_matches_the_reference(stepped):
    model, _, directions, _, _, ref_dirs = stepped
    assert set(directions) == set(ref_dirs)
    moved = 0
    for name, got in directions.items():
        want = ref_dirs[name]
        tol = 1e-4 * float(want.abs().max()) + 1e-9
        assert float((got - want).abs().max()) <= tol, name
        moved += name.startswith("roi_heads.2.") and float(want.abs().max()) > 0
    assert moved == 8  # the last stage's fc layers, class and box layers all learn


def test_sgd_update_matches_the_reference(stepped):
    model, _, _, ref, _, _ = stepped
    params = ref.params()
    for name, p in model.named_parameters():
        want = params[name].detach()
        assert float((p.detach() - want).abs().max()) <= 1e-6 * float(want.abs().max()) + 1e-9, name


def _stage_inputs(model, cfg, batch, seed=1):
    """The port's targets of all three stages, each later stage's made
    from the deltas of the port's head, and those deltas."""
    gen = torch.Generator().manual_seed(seed)
    b, h, w = batch["image"].shape[:3]
    anchors = pfr.device_anchors(model, h, w, "cpu")
    with torch.no_grad():
        feats = model.features(batch["image"].permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
        noise = pfr.draw_train_noise(gen, cfg, b, anchors.shape[0], batch["gt_boxes"].shape[1], "cpu")
        _, tg = pfr.train_targets(cfg, anchors, rpn_cls, rpn_reg, *(batch[k] for k in KEYS[1:]), noise)
        out, regs, num_rois = [tg], [], cfg.post_nms_train
        for t in range(2):
            _, reg = model.head(feats, tg.rois, CANVAS, stage=t)
            regs.append(reg)
            tg = pfr.next_stage_targets(
                cfg, t, tg, reg, num_rois, batch["extent"], batch["gt_boxes"], batch["gt_labels"],
                batch["gt_mask"], noise.stage_pos[:, t], noise.stage_neg[:, t],
            )
            out.append(tg)
            num_rois = cfg.roi_samples
    return out, regs, rpn_cls, rpn_reg, noise


@pytest.mark.parametrize("reals", [(4, 2), (3, 0)], ids=["gt_both", "no_gt_in_one"])
def test_each_stages_targets_match_the_reference(reals):
    model, cfg = make_model()
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = make_batch(reals=reals)
    port, regs, rpn_cls, rpn_reg, _ = _stage_inputs(model, cfg, batch)
    ref = rc.CascadeReference(budgets(cfg), weights, "cpu")
    noise = reference_noise(torch.Generator().manual_seed(1), cfg, batch)
    with torch.no_grad():
        _, tg = ref.targets(batch, noise, rpn_cls, rpn_reg)
        n_rois = cfg.post_nms_train
        for t in range(3):
            got = port[t]
            s_rois, labels, reg_t, idx, taken = tg
            assert torch.equal(got.labels, labels), t
            assert torch.equal(got.index, idx) and torch.equal(got.valid, taken), t
            torch.testing.assert_close(got.rois, s_rois, rtol=0, atol=1e-6)
            torch.testing.assert_close(got.reg_targets, reg_t, rtol=0, atol=1e-5)
            if t == 2:
                break
            masked = taken & (idx < n_rois)
            # slots that held a gt or padding leave the next candidates
            assert bool((~masked & taken).any()) == bool(batch["gt_mask"].any()), t
            boxes = rc.refine(s_rois, regs[t], ref.stages.std(t), batch["extent"])
            tg = ref.sample(batch, boxes, masked, noise[4 + 2 * t], noise[5 + 2 * t], t + 1)
            n_rois = cfg.roi_samples
    assert int(port[2].is_pos.sum()) > 0


def test_later_stages_sample_only_valid_rows():
    """Stage 2 of a batch of two: image 0 without gt, image 1 whose many
    near-gt rois exceed the positive quota; a third of each image's
    slots unfilled and some slots gt-derived."""
    cfg = dataclasses.replace(pfr.CASCADE_CONFIG, roi_samples=48, roi_pos_quota=8)
    b, s, g = 2, cfg.roi_samples, 3
    rs = np.random.RandomState(4)
    gt = torch.zeros(b, g, 4)
    gt[1] = torch.tensor([[0.1, 0.1, 0.4, 0.5], [0.5, 0.2, 0.9, 0.6], [0.2, 0.6, 0.5, 0.9]])
    gt_mask = torch.tensor([[False] * g, [True] * g])
    near = gt[1][torch.from_numpy(rs.randint(0, g, s))] + torch.from_numpy(rs.normal(0, 0.01, (s, 4))).float()
    rois = torch.stack([torch.from_numpy(rs.uniform(0, 0.5, (s, 4))).float().sort(-1)[0], near.clamp(0, 1)])
    rois = torch.cat([torch.minimum(rois[..., :2], rois[..., 2:]), torch.maximum(rois[..., :2], rois[..., 2:])], -1)
    valid = torch.ones(b, s, dtype=torch.bool)
    valid[:, -s // 3 :] = False
    index = torch.arange(s).repeat(b, 1)
    index[:, :4] = cfg.post_nms_train + torch.arange(4)  # four slots held a gt
    prev = pt.RoITargets(rois, torch.zeros(b, s, dtype=torch.int32), torch.zeros(b, s, 4),
                         torch.zeros(b, s, dtype=torch.bool), valid, index)
    gen = torch.Generator().manual_seed(2)
    pos, neg = (torch.rand(b, s + g, generator=gen) for _ in range(2))
    got = pfr.next_stage_targets(
        cfg, 0, prev, torch.zeros(b, s, 4), cfg.post_nms_train, torch.ones(b, 2), gt,
        torch.randint(1, 5, (b, g), dtype=torch.int32), gt_mask, pos, neg,
    )
    usable = torch.cat([valid & (index < cfg.post_nms_train), gt_mask], 1)
    assert bool(usable.gather(1, got.index)[got.valid].all())
    # no gt: every IoU is masked to -1, so nothing is sampled (as in stage 1)
    assert not bool(got.valid[0].any())
    assert int(got.is_pos[1].sum()) == cfg.roi_pos_quota
    assert 0 < int(got.valid[1].sum()) <= int(usable[1].sum()) < s
    assert bool((got.labels[~got.valid] == -1).all()) and bool((got.labels[got.is_pos] > 0).all())


def test_skipping_the_refinement_is_caught(stepped, monkeypatch):
    _, _, _, _, losses, _ = stepped
    monkeypatch.setattr(pfr, "refine_boxes", lambda rois, reg, std, extents: rois)
    model, cfg = make_model()
    metrics, _ = port_step(model, cfg, make_batch())
    assert float(metrics["loss"]) != pytest.approx(float(losses[0]), rel=1e-5, abs=1e-7)


def test_predict_matches_the_reference():
    model, cfg = make_model(seed=2)
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = make_batch(seed=3)
    with shared_proposals(), torch.no_grad():
        det = pfr.predict(model, cfg, batch["image"], batch["extent"], cfg.score_threshold)
        ref = rc.CascadeReference(budgets(cfg), weights, "cpu")
        want = ref.predict(batch["image"], batch["extent"], torch.float32)
    got = []
    for i in range(det.valid.shape[0]):
        v = det.valid[i]
        got.append(tuple(x[i][v].numpy() for x in (det.boxes, det.labels, det.scores)))
    want = [tuple(x.numpy() for x in w) for w in want]
    assert sum(len(w[2]) for w in want) > 0
    numbers = compare.predict_numbers(got, want)
    assert numbers["unmatched_share"] == 0.0 and numbers["score_gap"] <= 1e-5, numbers


@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_one_head_generations_take_the_new_defaults(generation):
    """The stage arguments default to the one head's constants: the
    sampling with them given equals the sampling without, the train step's
    loss is ``train_losses``', and ``detect`` ignores the extents."""
    model, cfg = pfr.build_model(generation, num_classes=NUM_CLASSES)
    pfr.init_weights(model, torch.Generator().manual_seed(0))
    assert not cfg.stage_ious and not cfg.stage_reg_stds
    batch = make_batch()
    if generation == "legacy":
        h, w = 128, 192
        batch["image"] = torch.from_numpy(np.random.RandomState(5).normal(size=(2, h, w, 3)).astype(np.float32))
    canvas = tuple(batch["image"].shape[1:3])
    gen = torch.Generator().manual_seed(1)
    anchors = pfr.device_anchors(model, *canvas, "cpu")
    with torch.no_grad():
        feats = model.features(batch["image"].permute(0, 3, 1, 2).contiguous())
        rpn_cls, rpn_reg = model.rpn_out(feats)
        g = batch["gt_boxes"].shape[1]
        noise = pfr.draw_train_noise(gen, cfg, 2, anchors.shape[0], g, "cpu")
        assert type(noise) is pfr.TrainNoise
        assert pfr.roi_stages(cfg) == (pfr.RoIStage(cfg.roi_pos_iou, pt.REG_STD, 1.0),)
        rpn_tg, roi_tg = pfr.train_targets(cfg, anchors, rpn_cls, rpn_reg, *(batch[k] for k in KEYS[1:]), noise)
        props = pfr.propose_batch(rpn_cls, rpn_reg, anchors, batch["extent"], pre_k=cfg.pre_nms_train,
                                  post_k=cfg.post_nms_train, nms_iou=cfg.rpn_nms_iou,
                                  min_size=cfg.proposal_min_size,
                                  nms_tile=cfg.rpn_nms_tile_train or cfg.rpn_nms_tile)
        cand = torch.cat([props.rois, batch["gt_boxes"]], 1)
        cvalid = torch.cat([props.valid, batch["gt_mask"]], 1)
        iou_max, iou_arg = pt.roi_match(cand, cvalid, batch["gt_boxes"], batch["gt_mask"])
        args = (cand, cvalid, iou_max, iou_arg, batch["gt_boxes"], batch["gt_labels"], noise.roi_pos, noise.roi_neg)
        kw = dict(num_samples=cfg.roi_samples, pos_quota=cfg.roi_pos_quota, label_offset=cfg.label_offset)
        plain = pt.sample_roi_targets(*args, **kw)
        given = pt.sample_roi_targets(*args, **kw, pos_iou=0.5, reg_std=pt.REG_STD)
        for a, b_, c in zip(plain, given, roi_tg):
            assert torch.equal(a, b_) and torch.equal(a, c)
        loss = pfr.train_losses(model, cfg, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, canvas)
        out = pfr.forward_train(model, cfg, *(batch[k] for k in KEYS), noise=noise)
        assert all(torch.equal(x, y) for x, y in zip(out.losses, loss.losses))
        det = pfr.detect(model, cfg, feats, props.rois, props.valid, canvas, 0.05)
        det_ext = pfr.detect(model, cfg, feats, props.rois, props.valid, canvas, 0.05, extents=batch["extent"])
        assert all(torch.equal(x, y) for x, y in zip(det, det_ext))


@pytest.mark.parametrize("generation", ["fpn", "cascade"])
def test_a_ranks_noise_is_its_rows_of_the_global_draw(generation):
    """Under data parallelism each rank draws the global batch's noise and
    keeps its rows, a cascade's later stages' too."""
    model, cfg = pfr.build_model(generation, num_classes=NUM_CLASSES)
    batch = make_batch(reals=(4, 2, 3, 1))
    n_anchors = pfr.device_anchors(model, *CANVAS, "cpu").shape[0]
    g = batch["gt_boxes"].shape[1]
    full = pfr.draw_train_noise(torch.Generator().manual_seed(7), cfg, 4, n_anchors, g, "cpu")
    mine = pts.batch_noise(
        model, cfg, torch.Generator().manual_seed(7), batch["image"][2:], batch["gt_boxes"][2:], (2, 4)
    )
    assert type(mine) is type(full)
    assert type(full) is (pfr.CascadeNoise if generation == "cascade" else pfr.TrainNoise)
    for name, want in zip(full._fields, full):
        assert torch.equal(getattr(mine, name), want[2:]), name
    if generation == "cascade":
        assert tuple(mine.stage_pos.shape) == (2, 2, cfg.roi_samples + g)


def test_the_loss_weights_each_stage_over_its_own_count():
    """``frcnn_loss``: the RPN terms, then each stage's pair over its own
    non-ignored count, times its weight; one stage of weight 1 is the
    four-part loss."""
    from faster_rcnn_pytorch_tpu_torch.models import losses as pl

    gen = torch.Generator().manual_seed(0)
    rpn = (torch.randn(2, 30, 2, generator=gen), torch.randn(2, 30, 4, generator=gen))
    rpn_tg = (torch.randint(-1, 2, (2, 30), generator=gen), torch.randn(2, 30, 4, generator=gen))
    stages = []
    for n_ignored in (3, 9):
        labels = torch.randint(0, 4, (2, 12), generator=gen)
        labels[0, :n_ignored] = -1
        stages.append(pl.stage_sums(torch.randn(2, 12, 4, generator=gen), torch.randn(2, 12, 4, generator=gen),
                                    labels, torch.randn(2, 12, 4, generator=gen)))
    both = pl.frcnn_loss(rpn, rpn_tg, stages, (1.0, 0.5))
    first = pl.frcnn_loss(rpn, rpn_tg, stages[:1])
    ce, reg, n = stages[1]
    assert int(n) == 24 - 9
    torch.testing.assert_close(both.roi_cls, first.roi_cls + 0.5 * ce / n, rtol=1e-6, atol=0)
    torch.testing.assert_close(both.roi_reg, first.roi_reg + 0.5 * reg / n, rtol=1e-6, atol=0)
    assert torch.equal(both.rpn_cls, first.rpn_cls) and torch.equal(both.rpn_reg, first.rpn_reg)
    torch.testing.assert_close(both.total, sum(both[1:]), rtol=1e-6, atol=0)


def test_cascade_build_and_cli_helpers():
    model, cfg = pfr.build_model("cascade")
    assert cfg.num_classes == 91 and cfg.roi_samples == 512 and cfg.post_nms_train == 1000
    stages = pfr.roi_stages(cfg)
    assert [s.iou for s in stages] == [0.5, 0.6, 0.7] and [s.weight for s in stages] == [1.0, 0.5, 0.25]
    assert stages[1].reg_std == (0.05, 0.05, 0.1, 0.1) and len(cfg.stage_reg_stds) == 12
    heads = [n for n, _ in model.named_parameters() if n.startswith("roi_heads.")]
    assert len(heads) == 3 * 8
    assert tuple(model.roi_heads[0].reg_head.weight.shape) == (4, 1024)
    assert not hasattr(model, "frcnn_head")
    assert pfr.label_offset_for("cascade", "coco") == 0 and pfr.label_offset_for("cascade", "voc") == 1
    with pytest.raises(ValueError, match="cascade"):
        from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel

        apply_tensor_parallel(model, None, 0, 2)


def test_main_trains_the_cascade_on_coco(tmp_path, monkeypatch):
    from faster_rcnn_pytorch_tpu_torch.main import main
    from tests.test_torch_fpn_train_cli import _args, _split

    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    rs = np.random.RandomState(2)
    _split(root, "train2017", 4, rs)
    _split(root, "val2017", 2, rs)
    log_dir = str(tmp_path / "logs")
    out = io.StringIO()
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    with contextlib.redirect_stdout(out):
        assert main(_args(str(root), log_dir, "cascade")) == 0
    text = out.getvalue()
    assert "epoch 0: mAP = " in text and text.count(" loss: ") == 2, text
    ckpt = torch.load(os.path.join(log_dir, "run", "saves", "run.0.pt"), weights_only=True)
    assert ckpt["step"] == 2
    assert ckpt["model"]["roi_heads.2.cls_head.weight"].shape[0] == 91
    assert json.dumps(ckpt["metadata"]) == '{"epoch": 0}'

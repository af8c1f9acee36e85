"""One ResNet50-FPN train step of the port against the JAX package's.

Shared weights: ``fpn_models`` of test_torch_resnet_fpn (JAX
``init_detector_params``, 6 classes, seeded FrozenBN statistics) loaded
through ``fpn_state_dict_from_jax``; a 128x160 canvas, batch 2, the JAX
package's ``FPN_CONFIG`` budgets (4000 -> 1000 proposals, 256 RPN
anchors with ties, 512 rois with 128 positives, no boundary filter, raw
label ids with offset 0), float32, and JAX's own sampling noise recreated
from the key ``forward_train`` splits.

* Targets: the port's ``train_targets`` on the JAX RPN outputs equal the
  JAX package's ``propose``/``rpn_targets``/``frcnn_targets`` (labels and
  masks identical; rois within atol 1e-6, regression targets within atol
  1e-6 plus relative 1e-5: they are logs of ratios of the decoded rois
  divided by REG_STD 0.1 / 0.2, and one of 2048 here differs by 1.5e-6 at
  0.64), and so do ``num_pos_*``.
* Losses on those targets: relative 1e-5 of ``forward_train``'s.
* Parameter gradients: every tensor within ``1e-4 * max|g|`` of JAX's
  (conv stacks and the align backward sum in other orders). ``conv1``
  and ``layer1`` get none in the port (``None``: the activations are
  detached after the stem's max pool and after ``layer1``) and exactly
  zero in JAX (``stop_gradient``).
* SGD: two steps of the port's optimizer on JAX's gradients (the frozen
  ones left ``None``) within relative 1e-5 of optax's, per tensor,
  including ``conv1`` and ``layer1``, which only weight decay and
  momentum move.
* The legacy step is unchanged: every legacy parameter gets a gradient,
  and ``make_train_step`` gives the parameters of a plain
  ``torch.optim.SGD`` step bit for bit.
* ``forward_train`` sizes its noise by the model's anchors (268,569 for
  FPN at 800x1344) and ``post_nms_train + G`` candidates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.models.rpn import propose as jax_propose
from faster_rcnn_pytorch_tpu.models.targets import frcnn_targets as jax_frcnn_targets
from faster_rcnn_pytorch_tpu.models.targets import rpn_targets as jax_rpn_targets
from faster_rcnn_pytorch_tpu.parallel import train_step as jts
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.parallel import train_step as pts
from faster_rcnn_pytorch_tpu_torch.utils.convert import fpn_state_dict_from_jax
from tests import test_torch_train_step as legacy
from tests.test_torch_resnet_fpn import fpn_models
from tests.test_torch_train_step import KEYS, jax_noise

CANVAS_HW = (128, 160)
NUM_CLASSES = 6
CFG = dataclasses.replace(jfr.FPN_CONFIG, num_classes=NUM_CLASSES)
FROZEN = ("backbone.body.conv1.", "backbone.body.layer1.")


def make_batch(seed=0, b=2, g=4):
    """Two images with 3 real boxes each (raw ids 1..5) and one padded slot."""
    batch = legacy.make_batch(seed, b, g)
    rs = np.random.RandomState(seed + 1)
    batch["image"] = rs.normal(size=(b, *CANVAS_HW, 3)).astype(np.float32)
    batch["gt_labels"] = rs.randint(1, NUM_CLASSES, size=(b, g)).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def setup():
    jmodel, _, params, pmodel, pcfg = fpn_models(NUM_CLASSES)
    assert pcfg.label_offset == CFG.label_offset == 0 and pcfg.rpn_allow_ties
    batch = make_batch()
    rng = jax.random.key(1)
    anchors = pmodel.canvas_anchors(*CANVAS_HW)
    noise = jax_noise(rng, 2, anchors.shape[0], CFG.post_nms_train + batch["gt_boxes"].shape[1])
    return jmodel, params, pmodel, batch, rng, anchors, noise


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX loss, metrics and gradients of one ``forward_train``."""
    jmodel, params, _, batch, rng, _, _ = setup
    args = [jnp.asarray(batch[k]) for k in KEYS]

    def loss_fn(p):
        out = jmodel.apply(p, CFG, *args, rng, method=jfr.forward_train)
        return out.losses.total, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return out, jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def port_targets(setup):
    """The port's targets from the JAX package's RPN outputs."""
    jmodel, params, _, batch, _, anchors, noise = setup
    feats = jmodel.apply(params, jnp.asarray(batch["image"]), True, method="features")
    rpn_cls, rpn_reg = jmodel.apply(params, feats, method="rpn_out")
    tg = pfr.train_targets(
        CFG, torch.tensor(anchors), torch.tensor(np.asarray(rpn_cls)),
        torch.tensor(np.asarray(rpn_reg)), *(torch.tensor(batch[k]) for k in KEYS[1:]), noise,
    )
    return tg, (rpn_cls, rpn_reg)


def test_targets_match_jax(setup, port_targets, jax_step):
    _, _, _, batch, rng, anchors, _ = setup
    (rpn_tg, roi_tg), (rpn_cls, rpn_reg) = port_targets
    rngs = jax.random.split(rng, (2, 3))
    for i in range(2):
        props = jax_propose(
            rpn_cls[i], rpn_reg[i], jnp.asarray(anchors), jnp.asarray(batch["extent"][i]),
            pre_k=CFG.pre_nms_train, post_k=CFG.post_nms_train, nms_iou=CFG.rpn_nms_iou,
            min_size=CFG.proposal_min_size, nms_tile=CFG.rpn_nms_tile_train or CFG.rpn_nms_tile,
        )
        want_rpn = jax_rpn_targets(
            jnp.asarray(anchors), jnp.asarray(batch["gt_boxes"][i]), jnp.asarray(batch["gt_mask"][i]),
            jnp.asarray(batch["extent"][i]), rngs[i, 0], allow_ties=CFG.rpn_allow_ties,
            boundary_filter=CFG.rpn_boundary_filter,
        )
        want_roi = jax_frcnn_targets(
            props.rois, props.valid, jnp.asarray(batch["gt_boxes"][i]),
            jnp.asarray(batch["gt_labels"][i]), jnp.asarray(batch["gt_mask"][i]), rngs[i, 1],
            num_samples=CFG.roi_samples, pos_quota=CFG.roi_pos_quota,
            label_offset=CFG.label_offset,
        )
        np.testing.assert_array_equal(rpn_tg.labels[i].numpy(), np.asarray(want_rpn.labels))
        np.testing.assert_allclose(
            rpn_tg.reg_targets[i].numpy(), np.asarray(want_rpn.reg_targets), rtol=0, atol=1e-6
        )
        for name in ("labels", "is_pos", "valid"):
            np.testing.assert_array_equal(
                getattr(roi_tg, name)[i].numpy(), np.asarray(getattr(want_roi, name)), err_msg=name
            )
        np.testing.assert_allclose(roi_tg.rois[i].numpy(), np.asarray(want_roi.rois), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            roi_tg.reg_targets[i].numpy(), np.asarray(want_roi.reg_targets), rtol=1e-5, atol=1e-6
        )
    out, _ = jax_step
    assert roi_tg.labels.shape == (2, CFG.roi_samples)
    assert int(roi_tg.is_pos.sum()) == int(out.num_pos_roi) > 0
    assert int((rpn_tg.labels == 1).sum()) == int(out.num_pos_rpn) > 0
    # raw ids, no offset: the positives carry the gt labels 1..5 themselves
    assert set(roi_tg.labels[roi_tg.is_pos].tolist()) <= set(batch["gt_labels"].ravel().tolist())


@pytest.fixture(scope="module")
def port_step(setup, port_targets):
    _, _, pmodel, batch, _, _, _ = setup
    (rpn_tg, roi_tg), _ = port_targets
    pmodel.zero_grad(set_to_none=True)
    feats = pmodel.features(torch.tensor(batch["image"]).permute(0, 3, 1, 2).contiguous())
    rpn_cls, rpn_reg = pmodel.rpn_out(feats)
    out = pfr.train_losses(pmodel, CFG, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, CANVAS_HW)
    out.losses.total.backward()
    grads = {n: None if p.grad is None else p.grad.clone() for n, p in pmodel.named_parameters()}
    pmodel.zero_grad(set_to_none=True)
    return out, grads


def test_losses_match_jax(jax_step, port_step):
    want, _ = jax_step
    got, _ = port_step
    for name in pfr.LossBreakdown._fields:
        w, g = float(getattr(want.losses, name)), float(getattr(got.losses, name).detach())
        assert abs(g - w) <= 1e-5 * abs(w), (name, g, w)
    assert float(got.losses.total.detach()) > 0


def test_parameter_gradients_match_jax(jax_step, port_step):
    _, jgrads = jax_step
    _, pgrads = port_step
    want = fpn_state_dict_from_jax(jgrads)
    assert set(pgrads) <= set(want)
    frozen = [n for n in pgrads if n.startswith(FROZEN)]
    assert len(frozen) == 1 + 3 * 3 + 1  # conv1, three bottlenecks' convs, a downsample
    for name, g in pgrads.items():
        w = want[name].numpy()
        if name.startswith(FROZEN):
            assert g is None and not w.any(), name
            continue
        assert np.abs(w).max() > 0, name
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err, np.abs(w).max())


def test_sgd_two_steps_match_optax_including_the_frozen_stages(setup, jax_step):
    """JAX's gradients into both optimizers; the port's frozen parameters
    keep ``.grad = None``, so only the zero fill, decay and momentum move
    them. lr 0.1 and weight decay 0.05 make the decay visible."""
    _, params, pmodel, _, _, _, _ = setup
    _, jgrads = jax_step
    lr, wd = 0.1, 0.05
    jsched = jts.make_lr_schedule("constant", lr, 1, 2)
    psched = pts.make_lr_schedule("constant", lr, 1, 2)
    opt = jts.make_optimizer(params, jsched, momentum=0.9, weight_decay=wd)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jparams)
    before = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    state = pts.init_train_state(pmodel, pts.make_optimizer(pmodel, momentum=0.9, weight_decay=wd))
    grads = fpn_state_dict_from_jax(jgrads)
    for _ in range(2):
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, jgrads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in pmodel.named_parameters():
            p.grad = None if n.startswith(FROZEN) else grads[n].clone()
        pts.apply_gradients(state, psched)
    assert state.step == 2
    want = fpn_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    try:
        for n, p in pmodel.named_parameters():
            w = want[n].numpy()
            assert not np.array_equal(w, before[n].numpy()), n
            assert np.abs(p.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max(), n
            if n.startswith(FROZEN):  # two decayed momentum steps with a = lr wd:
                a = lr * wd  # p1 = (1 - a) p0, p2 = p1 - a (0.9 p0 + p1)
                want_p2 = before[n].numpy() * (1 - 2.9 * a + a * a)
                np.testing.assert_allclose(w, want_p2, rtol=1e-5, atol=1e-7)
    finally:
        with torch.no_grad():  # leave the module's weights as the fixture made them
            for n, p in pmodel.named_parameters():
                p.copy_(before[n])
                p.grad = None


def test_legacy_step_is_unchanged():
    """Every legacy parameter gets a gradient, so the zero fill touches
    none, and one ``make_train_step`` step equals forward, backward and a
    plain ``torch.optim.SGD`` step bit for bit."""
    model, cfg = pfr.build_model("legacy", num_classes=NUM_CLASSES)
    pfr.init_weights(model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: torch.tensor(v) for k, v in legacy.make_batch().items()}
    lr, wd = 0.01, 5e-4

    model.zero_grad(set_to_none=True)
    out = pfr.forward_train(
        model, cfg, *(batch[k] for k in KEYS), generator=torch.Generator().manual_seed(3)
    )
    out.losses.total.backward()
    assert all(p.grad is not None for p in model.parameters())
    named = list(model.named_parameters())
    sgd = torch.optim.SGD(
        [
            {"params": [p for n, p in named if pts.decays(n)], "weight_decay": wd},
            {"params": [p for n, p in named if not pts.decays(n)], "weight_decay": 0.0},
        ],
        lr=lr, momentum=0.9,
    )
    sgd.step()
    want = {n: p.detach().clone() for n, p in named}

    model.load_state_dict(init)
    state = pts.init_train_state(model, pts.make_optimizer(model, momentum=0.9, weight_decay=wd))
    step_fn = pts.make_train_step(cfg, pts.make_lr_schedule("constant", lr, 1, 1))
    metrics = step_fn(state, batch, torch.Generator().manual_seed(3))
    assert float(metrics["loss"]) == float(out.losses.total.detach())
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n


def test_forward_train_sizes_its_noise_by_the_models_anchors(setup, monkeypatch):
    _, _, pmodel, batch, _, anchors, _ = setup
    assert pmodel.canvas_anchors(800, 1344).shape[0] == 268_569
    seen = []
    draw = pfr.draw_train_noise

    def spy(generator, b, num_anchors, num_candidates, device):
        seen.append((b, num_anchors, num_candidates))
        return draw(generator, b, num_anchors, num_candidates, device)

    monkeypatch.setattr(pfr, "draw_train_noise", spy)
    with torch.no_grad():
        out = pfr.forward_train(
            pmodel, CFG, *(torch.tensor(batch[k]) for k in KEYS),
            generator=torch.Generator().manual_seed(0),
        )
    g = batch["gt_boxes"].shape[1]
    assert seen == [(2, anchors.shape[0], CFG.post_nms_train + g)]
    assert all(torch.isfinite(t) for t in out.losses)

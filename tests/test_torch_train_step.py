"""One legacy train step of the port against the JAX package's.

Shared weights: ``init_detector_params`` (6 classes) loaded into the port
through ``legacy_state_dict_from_jax``; a 192x256 canvas, batch 2, the
JAX package's ``LEGACY_CONFIG`` budgets, float32 (TF32 off), and JAX's
own sampling noise recreated from the key ``forward_train`` splits.

* Targets: the port's ``train_targets`` on the JAX RPN outputs must equal
  the JAX package's ``propose``/``rpn_targets``/``frcnn_targets`` (labels
  and masks identical; sampled rois, decoded by two ``exp``s, and
  regression targets within atol 1e-6), and so must ``num_pos_*``. Proposals are compared on one set of RPN outputs:
  two conv stacks differ in the last bits, enough to swap near-tied
  scores and with them the sampled rois.
* Losses on those targets: relative 1e-5 of ``forward_train``'s.
* Parameter gradients (JAX's mapped by ``legacy_state_dict_from_jax``,
  which is linear): every one above the backbone's last max pool (conv5,
  RPN, head) within ``1e-4 * max|g|`` of the tensor. The convs under a
  2x2 max pool within ``2e-3`` relative L2 (measured at most 5.1e-4
  here): each step has a few pool windows whose top two values lie
  within the frameworks' ~1e-6 conv difference, so the pool routes that
  window's gradient to another cell, and the weight gradients below sum
  that error over every position. Parameter gradients, not
  ``dL/dfeatures``: ReLU before RoIPool zeroes the tie cases, where JAX's
  lax max splits a gradient and the port's argmax backward does not.
* SGD with momentum and the ``bn`` decay rule: parameters after two
  steps within relative 1e-5 of optax's; every LR schedule within atol
  1e-7 of the JAX one.
* ``grad_accum=2``: the step's gradient is the mean of the micro-batch
  gradients.
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
from faster_rcnn_pytorch_tpu_torch.utils.convert import legacy_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics

CANVAS_HW = (192, 256)
NUM_CLASSES = 6
CFG = dataclasses.replace(jfr.LEGACY_CONFIG, num_classes=NUM_CLASSES)
KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")


def make_batch(seed=0, b=2, g=4):
    rs = np.random.RandomState(seed)
    images = rs.normal(size=(b, *CANVAS_HW, 3)).astype(np.float32)
    extents = np.array([[1.0, 1.0], [0.9, 0.85]], np.float32)[:b]
    xy = rs.uniform(0.05, 0.35, size=(b, g, 2))
    wh = rs.uniform(0.3, 0.55, size=(b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 0.84)], -1).astype(np.float32)
    labels = rs.randint(0, NUM_CLASSES - 1, size=(b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[:, -1] = False
    boxes[:, -1] = 0.0
    return dict(zip(KEYS, (images, extents, boxes, labels, mask)))


def jax_noise(rng, b, num_anchors, num_cand):
    """The noise ``forward_train`` draws from ``rng``: per image,
    ``split(rngs[i, 0])`` for the RPN quotas and ``split(rngs[i, 1])`` for
    the RoI quotas, each pair ``uniform``."""
    rngs = jax.random.split(rng, (b, 3))

    def pair(key, n):
        k_pos, k_neg = jax.random.split(key)
        return np.asarray(jax.random.uniform(k_pos, (n,))), np.asarray(jax.random.uniform(k_neg, (n,)))

    rpn = [pair(rngs[i, 0], num_anchors) for i in range(b)]
    roi = [pair(rngs[i, 1], num_cand) for i in range(b)]
    return pfr.TrainNoise(
        *(torch.tensor(np.stack([p[k] for p in parts])) for parts, k in ((rpn, 0), (rpn, 1), (roi, 0), (roi, 1)))
    )


@pytest.fixture(scope="module")
def setup():
    set_numerics("float32")
    jmodel, _ = jfr.build_model("legacy", num_classes=NUM_CLASSES, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(0), canvas=64))
    pmodel, _ = pfr.build_model("legacy", num_classes=NUM_CLASSES)
    pmodel.load_state_dict(legacy_state_dict_from_jax(params), strict=True)
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
    """The port's targets from the JAX package's RPN outputs (the ones
    JAX's ``forward_train`` sees: ``features(train=True)``)."""
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
            min_size=CFG.proposal_min_size, nms_tile=CFG.rpn_nms_tile_train,
        )
        want_rpn = jax_rpn_targets(
            jnp.asarray(anchors), jnp.asarray(batch["gt_boxes"][i]), jnp.asarray(batch["gt_mask"][i]),
            jnp.asarray(batch["extent"][i]), rngs[i, 0],
        )
        want_roi = jax_frcnn_targets(
            props.rois, props.valid, jnp.asarray(batch["gt_boxes"][i]),
            jnp.asarray(batch["gt_labels"][i]), jnp.asarray(batch["gt_mask"][i]), rngs[i, 1],
            num_samples=CFG.roi_samples, pos_quota=CFG.roi_pos_quota,
        )
        np.testing.assert_array_equal(rpn_tg.labels[i].numpy(), np.asarray(want_rpn.labels))
        np.testing.assert_allclose(
            rpn_tg.reg_targets[i].numpy(), np.asarray(want_rpn.reg_targets), rtol=0, atol=1e-6
        )
        for name in ("labels", "is_pos", "valid"):
            np.testing.assert_array_equal(
                getattr(roi_tg, name)[i].numpy(), np.asarray(getattr(want_roi, name)), err_msg=name
            )
        for name in ("rois", "reg_targets"):
            np.testing.assert_allclose(
                getattr(roi_tg, name)[i].numpy(), np.asarray(getattr(want_roi, name)),
                rtol=0, atol=1e-6, err_msg=name,
            )
    out, _ = jax_step
    assert int(roi_tg.is_pos.sum()) == int(out.num_pos_roi) > 0
    assert int((rpn_tg.labels == 1).sum()) == int(out.num_pos_rpn) > 0


@pytest.fixture(scope="module")
def port_step(setup, port_targets):
    _, _, pmodel, batch, _, _, _ = setup
    (rpn_tg, roi_tg), _ = port_targets
    pmodel.zero_grad(set_to_none=True)
    feats = pmodel.features(torch.tensor(batch["image"]).permute(0, 3, 1, 2).contiguous())
    rpn_cls, rpn_reg = pmodel.rpn_out(feats)
    out = pfr.train_losses(pmodel, CFG, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, CANVAS_HW)
    out.losses.total.backward()
    grads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    pmodel.zero_grad(set_to_none=True)
    return out, grads


def test_losses_match_jax(jax_step, port_step):
    want, _ = jax_step
    got, _ = port_step
    for name in pfr.LossBreakdown._fields:
        w, g = float(getattr(want.losses, name)), float(getattr(got.losses, name).detach())
        assert abs(g - w) <= 1e-5 * abs(w), (name, g, w)
    assert float(got.losses.total.detach()) > 0


# The convs under a 2x2 max pool (pools follow conv 2, 7, 14 and 21).
_UNDER_A_POOL = {f"extractor.{i}" for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)}


def test_parameter_gradients_match_jax(jax_step, port_step):
    _, jgrads = jax_step
    _, pgrads = port_step
    want = legacy_state_dict_from_jax(jgrads)
    assert set(pgrads) <= set(want)
    for name, g in pgrads.items():
        w = want[name].numpy()
        d = g.numpy() - w
        assert np.abs(w).max() > 0, name
        if name.rsplit(".", 1)[0] in _UNDER_A_POOL:
            rel = np.linalg.norm(d) / np.linalg.norm(w)
            assert rel <= 2e-3, (name, rel)
        else:
            err = np.abs(d).max()
            assert err <= 1e-4 * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("cosine", dict(warmup_epochs=1)),
        ("multistep", dict(milestones=(2, 3))),
        ("constant", dict(warmup_epochs=1)),
        ("cosine_warmup_restarts", dict(first_cycle_epochs=2, cycle_mult=1.5, restart_gamma=0.5)),
        ("cosine_warmup_restarts", dict(warmup_epochs=1, first_cycle_epochs=2, cycle_mult=2.0)),
    ],
)
def test_lr_schedules_match_jax(kind, kw):
    args = (kind, 0.02, 5, 7)
    want = jts.make_lr_schedule(*args, **kw)
    got = pts.make_lr_schedule(*args, **kw)
    for step in range(0, 40):
        assert abs(got(step) - float(want(step))) <= 1e-7, (step, got(step), float(want(step)))


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Linear(5, 3)
        self.layer1 = torch.nn.Module()
        self.layer1.bn1 = torch.nn.Linear(3, 1)


def test_sgd_two_steps_match_optax():
    rs = np.random.RandomState(4)
    toy = _Toy()
    p0 = {n: rs.normal(size=p.shape).astype(np.float32) for n, p in toy.named_parameters()}
    with torch.no_grad():
        for n, p in toy.named_parameters():
            p.copy_(torch.tensor(p0[n]))
    tree = {
        "conv": {"weight": p0["conv.weight"], "bias": p0["conv.bias"]},
        "layer1": {"bn1": {"weight": p0["layer1.bn1.weight"], "bias": p0["layer1.bn1.bias"]}},
    }
    assert [pts.decays(n) for n, _ in toy.named_parameters()] == [True, True, False, False]
    sched_args = ("cosine", 0.05, 2, 1)
    jsched = jts.make_lr_schedule(*sched_args, warmup_epochs=1)
    psched = pts.make_lr_schedule(*sched_args, warmup_epochs=1)
    opt = jts.make_optimizer(tree, jsched, momentum=0.9, weight_decay=0.01)
    jstate = opt.init(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = pts.init_train_state(toy, pts.make_optimizer(toy, momentum=0.9, weight_decay=0.01))
    for _ in range(2):
        g = {n: rs.normal(size=v.shape).astype(np.float32) for n, v in p0.items()}
        jg = {
            "conv": {"weight": g["conv.weight"], "bias": g["conv.bias"]},
            "layer1": {"bn1": {"weight": g["layer1.bn1.weight"], "bias": g["layer1.bn1.bias"]}},
        }
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, jg), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in toy.named_parameters():
            p.grad = torch.tensor(g[n])
        pts.apply_gradients(state, psched)
    assert state.step == 2
    want = {
        "conv.weight": jparams["conv"]["weight"], "conv.bias": jparams["conv"]["bias"],
        "layer1.bn1.weight": jparams["layer1"]["bn1"]["weight"],
        "layer1.bn1.bias": jparams["layer1"]["bn1"]["bias"],
    }
    for n, p in toy.named_parameters():
        w = np.asarray(want[n])
        assert not np.allclose(w, p0[n])
        assert np.abs(p.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max(), n


def test_grad_accum_is_the_mean_of_micro_batch_gradients(setup):
    _, _, pmodel, batch, _, _, _ = setup
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    micro_grads, micro_loss = [], []
    gen = torch.Generator().manual_seed(5)
    for i in range(2):
        pmodel.zero_grad(set_to_none=True)
        out = pfr.forward_train(
            pmodel, CFG, *(tb[k][i::2] for k in KEYS), generator=gen
        )
        out.losses.total.backward()
        micro_loss.append(float(out.losses.total))
        micro_grads.append({n: p.grad.clone() for n, p in pmodel.named_parameters()})
    before = {n: p.detach().clone() for n, p in pmodel.named_parameters()}

    lr, wd = 0.01, 5e-4
    optimizer = pts.make_optimizer(pmodel, momentum=0.9, weight_decay=wd)
    state = pts.init_train_state(pmodel, optimizer)
    step_fn = pts.make_train_step(CFG, pts.make_lr_schedule("constant", lr, 1, 1), grad_accum=2)
    metrics = step_fn(state, tb, torch.Generator().manual_seed(5))
    assert state.step == 1 and set(metrics) == set(pts.METRIC_KEYS)
    assert abs(float(metrics["loss"]) - np.mean(micro_loss)) <= 1e-6 * abs(np.mean(micro_loss))
    for n, p in pmodel.named_parameters():
        want = (micro_grads[0][n] + micro_grads[1][n]) / 2
        torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-6 * float(want.abs().max()))
        # first momentum step: p - lr * (g + wd * p)
        torch.testing.assert_close(
            p.detach(), before[n] - lr * (want + wd * before[n]), rtol=1e-6, atol=1e-7
        )
    with torch.no_grad():  # leave the module's weights as the fixture made them
        for n, p in pmodel.named_parameters():
            p.copy_(before[n])

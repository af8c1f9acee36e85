"""One bfloat16 train step of the port against the JAX package's, both generations.

The recipes: the JAX package's model at ``dtype=bfloat16`` (``build_model``'s
default: bfloat16 compute over float32 params, ``main``'s train step); the
port's ``forward_train`` under ``torch.autocast(bfloat16)`` over float32
weights (``make_train_step(autocast_dtype=torch.bfloat16)``). Both start
from the same float32 weights (the JAX package's ``init_detector_params``,
VOC's 21 classes, exported into the port strict) on the first batch of
``tests/test_torch_loader_parity.py``'s stream, with the JAX step's
sampling noise.

The JAX step is ``value_and_grad`` of ``forward_train``. The port takes
the JAX step's targets: its ``train_targets`` on the JAX package's
bfloat16 RPN outputs (the same function of the same float32 logits, so
the same targets: the positives' counts are checked equal), then its
bfloat16 losses and backward. Its own RPN outputs differ from the JAX ones
by bfloat16 rounding, and the FPN generation's objectness is near-tied
at random weights, so its own proposals would differ by rounding at the
cuts (ROADMAP Queue C, C6). The float32 reference is the port's float32
step on the same targets (the JAX package's float32 step within 1e-4 of
``max|g|``, ``tests/test_torch_train_step.py`` and
``tests/test_torch_fpn_train_step.py``: far under a bfloat16 ulp).

Tolerances, in bfloat16 ulps at each tensor's ``max|x|`` (bfloat16 keeps 8
significant bits: ``ulp(x) = 2^(floor(log2 x) - 7)``):

* each loss within one ulp at its value: a float32 reduction of bfloat16
  outputs, each within a rounding (half an ulp) of the other package's;
* each parameter gradient within ``max(1, 2 e)`` ulps of the JAX
  package's, ``e`` the distance in ulps of the JAX bfloat16 gradient from
  the float32 one: two recipes as accurate as each other differ by at
  most the sum of their rounding errors, and one ulp is two roundings
  that went different ways. A cast or a reduction done in another dtype
  than the JAX package's makes the port's error larger than the JAX
  package's and fails it. Measured: at most 0.60 (legacy) and 0.78 (FPN)
  of the bound; the port's bias gradients of the FPN convs and of the
  linear heads are closer to float32 than the JAX package's (up to 177
  ulps from it on ``fpn.inner_blocks.0.0.bias``, the port 2.7): the port
  sums them in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils.convert import fpn_state_dict_from_jax, legacy_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics
from tests.test_torch_loader_parity import KEYS, SEED, loader_batches, make_voc_tree
from tests.test_torch_train_step import jax_noise

NUM_CLASSES = 21  # VOC
FROM_JAX = {"legacy": legacy_state_dict_from_jax, "fpn": fpn_state_dict_from_jax}


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    return loader_batches(make_voc_tree(tmp_path_factory.mktemp("voc_bf16_step")))[0]


def _port_step(model, cfg, batch, rpn_tg, roi_tg, autocast: bool):
    """The port's losses and parameter gradients on the given targets."""
    model.zero_grad(set_to_none=True)
    images = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).contiguous()
    ctx = torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast)
    with ctx:
        feats = model.features(images)
        rpn_cls, rpn_reg = model.rpn_out(feats)
        out = pfr.train_losses(model, cfg, feats, rpn_cls, rpn_reg, rpn_tg, roi_tg, batch["image"].shape[1:3])
    out.losses.total.backward()
    losses = {k: float(getattr(out.losses, k).detach()) for k in pfr.LossBreakdown._fields}
    grads = {  # under both names of the shared fc6/fc7
        n: p.grad.clone() for n, p in model.named_parameters(remove_duplicate=False) if p.grad is not None
    }
    model.zero_grad(set_to_none=True)
    return losses, grads


@pytest.fixture(scope="module", params=["legacy", "fpn"])
def steps(request, batch):
    """(generation, the JAX step's losses, counts and gradients, the
    port's bfloat16 losses and gradients, its float32 ones)."""
    generation = request.param
    set_numerics("float32")
    offset = jfr.label_offset_for(generation, "voc")
    jmodel, jcfg = jfr.build_model(generation, num_classes=NUM_CLASSES, label_offset=offset)
    assert jmodel.dtype == jnp.bfloat16
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(SEED), canvas=64))
    rng = jax.random.key(SEED + 1)
    args = [jnp.asarray(batch[k]) for k in KEYS]

    def loss_fn(p):
        out = jmodel.apply(p, jcfg, *args, rng, method=jfr.forward_train)
        return out.losses.total, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = (
        {k: float(getattr(out.losses, k)) for k in pfr.LossBreakdown._fields},
        (int(out.num_pos_roi), int(out.num_pos_rpn)),
        FROM_JAX[generation](jax.tree.map(np.asarray, grads)),
    )
    feats = jax.jit(lambda p, x: jmodel.apply(p, x, True, method="features"))(params, args[0])
    rpn_cls, rpn_reg = jax.jit(lambda p, f: jmodel.apply(p, f, method="rpn_out"))(params, feats)

    model, cfg = pfr.build_model(generation, NUM_CLASSES, label_offset=offset)
    model.load_state_dict(FROM_JAX[generation](params), strict=True)
    del params, feats
    anchors = torch.tensor(model.canvas_anchors(*batch["image"].shape[1:3]))
    noise = jax_noise(rng, batch["image"].shape[0], anchors.shape[0], cfg.post_nms_train + batch["gt_boxes"].shape[1])
    rpn_tg, roi_tg = pfr.train_targets(
        cfg, anchors, torch.tensor(np.asarray(rpn_cls)), torch.tensor(np.asarray(rpn_reg)),
        *(torch.from_numpy(batch[k]) for k in KEYS[1:]), noise,
    )
    counts = (int(roi_tg.is_pos.sum()), int((rpn_tg.labels == 1).sum()))
    got = _port_step(model, cfg, batch, rpn_tg, roi_tg, autocast=True)
    ref = _port_step(model, cfg, batch, rpn_tg, roi_tg, autocast=False)
    return generation, want, (counts, *got), ref


def test_losses_match_jax_within_a_bfloat16_ulp(steps):
    _, (want, want_counts, _), (counts, got, _), _ = steps
    assert counts == want_counts and min(counts) > 0  # the same targets
    for name, w in want.items():
        assert abs(got[name] - w) <= bf16_ulp(abs(w)), (name, got[name], w, bf16_ulp(abs(w)))


def test_gradients_match_jax_within_twice_its_rounding(steps):
    generation, (_, _, want), (_, _, got), (_, ref) = steps
    assert set(got) == set(ref)
    for name, w in want.items():
        if name not in got:  # a frozen stage, or a FrozenBN statistic: no gradient
            assert not w.any(), name
    compared = 0
    for name, g in got.items():
        w, f = want[name].numpy(), ref[name].numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        ulp = bf16_ulp(scale)
        err = np.abs(g.numpy() - w).max() / ulp
        rounding = np.abs(w - f).max() / ulp  # the JAX package's own bfloat16 error
        assert err <= max(1.0, 2 * rounding), (
            f"{generation} {name}: the port's bfloat16 gradient is {err:.2f} ulps from the JAX "
            f"package's, whose own is {rounding:.2f} from float32; the recipes differ in a dtype "
            "on this tensor's path"
        )
        compared += 1
    # legacy: VGG16's 26 weights and biases, the RPN's 6, the head's 8;
    # FPN: layer2-4's 42 conv weights, the FPN's 16, the RPN's 6, the head's
    # 8; both with fc6/fc7 under their second names (4)
    assert compared == {"legacy": 44, "fpn": 76}[generation]

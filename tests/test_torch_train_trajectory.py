"""Three float32 legacy train steps of the port against the JAX package's.

Both start from the same weights: the JAX package's ``init_detector_params``
(VOC's 21 classes, ``jax.random.key(7)``), exported into the port strict, so
this test does not depend on the two inits' agreement
(``tests/test_torch_init_parity.py``). The batches are the first three of
``tests/test_torch_loader_parity.py``'s loader stream (192x256 and 256x192
canvases, batch 2), which both packages' loaders give bit-equal. ``main``'s
defaults for the rest: the cosine schedule (lr 1e-3, ``eta_min`` 5e-5,
13 epochs of the loader's 4 steps), SGD with momentum 0.9 and weight decay
5e-4, float32 (TF32 off).

The JAX package runs its own ``make_train_step`` on a one-device mesh,
with the step keys its train loop splits from the epoch's key
(``seed * 100_003 + epoch``); the port runs its ``make_train_step`` fed
each step's sampling noise as the JAX step draws it from that key
(``tests/test_torch_train_step.py::jax_noise``). Each side proposes and
samples from its own RPN outputs. (The FPN generation is not held here:
at the JAX init its RPN logits differ between the packages by up to
4.2e-7 on these batches, and the port's own ``train_targets`` fed the two
packages' RPN outputs with the same noise samples other rois in both
images of the first batch, so its losses part at 2.2e-5 in the first
step: a rounding tie among near-equal objectness, as in Queue C's C6.
``tests/test_torch_fpn_train_step.py`` holds its step on the same
targets.)

Tolerances, from the one-step bounds of ``tests/test_torch_train_step.py``
(gradients within ``1e-4 * max|g|`` away from the pooled convs, within
``2e-3`` relative L2 under a 2x2 max pool; losses within relative
``1e-5``):

* the four losses at each step within relative ``K * 1e-5``: at step ``k``
  the weights carry ``k`` steps of update error, each at most the
  one-step gradient error times that step's learning rate, a change of
  the loss far under the one-step bound; ``K`` of them bound it;
* the change of every parameter over the ``K`` steps, ``dp = p_K - p_0``:
  away from the pooled convs ``max|dp - dp_jax| <= K * 1e-4 *
  max|dp_jax|``; under a pool ``|dp - dp_jax| <= K * 2e-3 * |dp_jax|``
  (L2). ``dp`` is a sum of ``K`` updates, each ``lr_k`` times a momentum
  trace whose error is at most the one-step bound of that step's
  gradients (the weight decay term is the same in both: the weights
  start equal); the errors add at most linearly over the ``K`` steps,
  and each step's update is about as large as ``dp / K`` (three steps of
  a near-constant learning rate along gradients of one scale). Both
  bounds add the weights' own rounding: each update rounds ``p`` to
  float32 in each package, half an ulp of ``max|p|`` at most, so ``K``
  ulps between the two (``sqrt(n)`` times that in L2 over ``n``
  weights). At lr about 1e-3 ``dp`` is about 1e-5 on conv5, where
  ``max|p|`` is about 0.03: one ulp there (1.9e-9) is 1.8e-4 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.parallel import train_step as jts
from faster_rcnn_pytorch_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.parallel import train_step as pts
from faster_rcnn_pytorch_tpu_torch.utils.convert import legacy_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics
from tests.test_torch_loader_parity import KEYS, SEED, loader_batches, make_voc_tree
from tests.test_torch_train_step import _UNDER_A_POOL, jax_noise

K = 3
LOSSES = ("loss", "rpn_cls", "rpn_reg", "roi_cls", "roi_reg")
NUM_CLASSES = 21  # VOC
STEPS_PER_EPOCH = 4  # 8 train images at batch 2


def schedule_args(opts) -> tuple[tuple, dict]:
    """``main``'s ``make_lr_schedule`` arguments for one epoch of
    ``STEPS_PER_EPOCH`` steps."""
    return (opts.scheduler, opts.lr, opts.epoch, STEPS_PER_EPOCH), dict(
        eta_min=opts.eta_min, warmup_epochs=opts.warmup_epoch
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the weights, (JAX metrics at each step, its weights after ``K``
    steps), the port's) from the same weights."""
    set_numerics("float32")
    batches = loader_batches(make_voc_tree(tmp_path_factory.mktemp("voc_trajectory")))[:K]
    opts = load_options([])
    args, kw = schedule_args(opts)

    jmodel, jcfg = jfr.build_model("legacy", num_classes=NUM_CLASSES, dtype=jnp.float32)
    params = jfr.init_detector_params(jmodel, jax.random.key(SEED), canvas=64)
    p0 = legacy_state_dict_from_jax(jax.tree.map(np.asarray, params))
    mesh = make_mesh(num_devices=1)
    optimizer = jts.make_optimizer(
        params, jts.make_lr_schedule(*args, **kw), momentum=opts.momentum, weight_decay=opts.weight_decay
    )
    state = replicate(jts.init_train_state(params, optimizer), mesh)
    step = jts.make_train_step(jmodel, jcfg, optimizer, mesh, donate=False)
    rng = jax.random.key(SEED * 100_003 + 0)
    keys, jax_losses = [], []
    for batch in batches:
        rng, step_rng = jax.random.split(rng)
        state, metrics = step(state, shard_batch(batch, mesh), step_rng)
        keys.append(step_rng)
        jax_losses.append({k: float(metrics[k]) for k in pts.METRIC_KEYS})
    jax_pk = legacy_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    del state, params

    pmodel, pcfg = pfr.build_model("legacy", NUM_CLASSES)
    pmodel.load_state_dict(p0, strict=True)
    pstate = pts.init_train_state(
        pmodel, pts.make_optimizer(pmodel, momentum=opts.momentum, weight_decay=opts.weight_decay)
    )
    pstep = pts.make_train_step(pcfg, pts.make_lr_schedule(*args, **kw))
    port_losses = []
    for batch, key in zip(batches, keys):
        tb = {k: torch.from_numpy(batch[k]) for k in KEYS}
        n_anchors = pmodel.canvas_anchors(*batch["image"].shape[1:3]).shape[0]
        noise = jax_noise(key, batch["image"].shape[0], n_anchors, pcfg.post_nms_train + batch["gt_boxes"].shape[1])
        metrics = pstep(pstate, tb, noise)
        port_losses.append({k: float(metrics[k]) for k in pts.METRIC_KEYS})
    port_pk = {k: v.detach().clone() for k, v in pmodel.state_dict().items()}
    return p0, (jax_losses, jax_pk), (port_losses, port_pk)


def test_losses_match_jax_at_every_step(runs):
    _, (want, _), (got, _) = runs
    assert len(got) == len(want) == K
    for k, (g, w) in enumerate(zip(got, want)):
        for name in LOSSES:
            assert abs(g[name] - w[name]) <= K * 1e-5 * abs(w[name]), (k, name, g[name], w[name])
        for name in ("num_pos_roi", "num_pos_rpn"):  # the same targets
            assert g[name] == w[name] > 0, (k, name, g[name], w[name])
    assert want[-1]["loss"] != want[0]["loss"]


def test_parameter_changes_match_jax(runs):
    p0, (_, want), (_, got) = runs
    assert set(got) == set(want) == set(p0)
    for name in got:
        dw = (want[name] - p0[name]).numpy()
        dg = (got[name] - p0[name]).numpy()
        assert np.abs(dw).max() > 0, name
        rounding = K * float(np.spacing(np.abs(want[name].numpy()).max()))
        if name.rsplit(".", 1)[0] in _UNDER_A_POOL:
            err = np.linalg.norm(dg - dw)
            assert err <= K * 2e-3 * np.linalg.norm(dw) + rounding * np.sqrt(dw.size), (name, err, np.linalg.norm(dw))
        else:
            err = np.abs(dg - dw).max()
            assert err <= K * 1e-4 * np.abs(dw).max() + rounding, (name, err, np.abs(dw).max(), rounding)

"""The port's ResNet50-FPN detector parts against the JAX package.

JAX params come from ``init_detector_params`` (7 classes) with every
FrozenBN group replaced by seeded non-trivial statistics (scale, bias,
mean, var), so the BN path is not the identity; the port loads them
through ``fpn_state_dict_from_jax``. Float32 throughout, at a 208x240
canvas: H/16 = 13 and H/32 = 7 are odd, so the top-down upsample 7 -> 13
is not a factor of two and only ``nearest-exact`` matches
``jax.image.resize(..., "nearest")``. Tolerances:

* state dict: identical to ``export_fpn_torch_state_dict``, key for key,
  and it loads with ``strict=True``;
* P2..P6, RPN outputs and the head's class and box outputs on the same
  rois: ``max|d| <= 1e-4 * max|ref|`` each (conv stacks summing in
  different orders; measured on this CPU at most 9.5e-7 for P2..P6 and
  1.5e-6 for the RPN outputs, while PyTorch's ``"nearest"`` upsample
  would miss P2..P4 by 3-7%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.utils.checkpoint import export_fpn_torch_state_dict
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils.convert import fpn_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics

CANVAS_HW = (208, 240)
NUM_CLASSES = 7


def _with_seeded_bn(tree, rs):
    """Every FrozenBN group {scale, bias, mean, var} -> seeded numpy values
    (scale in [0.3, 0.9], so the residual stream stays O(1))."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = np.asarray(tree["scale"]).shape
            return {
                "scale": rs.uniform(0.3, 0.9, n).astype(np.float32),
                "bias": rs.uniform(-0.2, 0.2, n).astype(np.float32),
                "mean": rs.uniform(-0.2, 0.2, n).astype(np.float32),
                "var": rs.uniform(0.5, 2.0, n).astype(np.float32),
            }
        return {k: _with_seeded_bn(v, rs) for k, v in tree.items()}
    return np.asarray(tree)


def fpn_models(num_classes=NUM_CLASSES, seed=0):
    """(JAX model, JAX config, numpy params with seeded BN, the port's model
    with those weights, the port's config)."""
    set_numerics("float32")
    jmodel, jcfg = jfr.build_model("fpn", num_classes=num_classes, dtype=jnp.float32)
    params = jfr.init_detector_params(jmodel, jax.random.key(seed), canvas=64)
    params = _with_seeded_bn(params, np.random.RandomState(seed))
    pmodel, pcfg = pfr.build_model("fpn", num_classes=num_classes)
    pmodel.load_state_dict(fpn_state_dict_from_jax(params), strict=True)
    pmodel.eval()
    return jmodel, jcfg, params, pmodel, pcfg


@pytest.fixture(scope="module")
def models():
    return fpn_models()


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).normal(size=(2, *CANVAS_HW, 3)).astype(np.float32)


def _rel_close(got, want, rel=1e-4):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())
    return err / np.abs(want).max()


def test_state_dict_from_jax_equals_export_and_loads_strictly(models):
    _, _, params, pmodel, _ = models
    want = export_fpn_torch_state_dict(params)
    got = fpn_state_dict_from_jax(params)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(pmodel.state_dict()) == set(want)
    assert pmodel.classifier is pmodel.frcnn_head.classifier


def test_pyramid_and_rpn_outputs_match_jax(models, images):
    jmodel, _, params, pmodel, _ = models
    j_feats = jmodel.apply(params, jnp.asarray(images), method="features")
    j_cls, j_reg = jmodel.apply(params, j_feats, method="rpn_out")
    with torch.no_grad():
        p_feats = pmodel.features(torch.tensor(images).permute(0, 3, 1, 2).contiguous())
        p_cls, p_reg = pmodel.rpn_out(p_feats)
    assert [tuple(f.shape[2:]) for f in p_feats] == [(52, 60), (26, 30), (13, 15), (7, 8), (4, 4)]
    for p, j in zip(p_feats, j_feats):
        _rel_close(p.permute(0, 2, 3, 1).numpy(), np.asarray(j))
    anchors = pmodel.canvas_anchors(*CANVAS_HW)
    assert p_cls.shape == j_cls.shape == (2, anchors.shape[0], 2)
    _rel_close(p_cls.numpy(), np.asarray(j_cls))
    _rel_close(p_reg.numpy(), np.asarray(j_reg))


def test_head_matches_jax_on_the_same_rois(models, images):
    jmodel, _, params, pmodel, _ = models
    rs = np.random.RandomState(1)
    xy = rs.uniform(0, 0.7, size=(2, 24, 2))
    wh = rs.uniform(0.02, 0.5, size=(2, 24, 2))
    rois = np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32)
    j_feats = jmodel.apply(params, jnp.asarray(images), method="features")
    j_cls, j_reg = jmodel.apply(
        params, j_feats, jnp.asarray(rois), CANVAS_HW, method="head"
    )
    with torch.no_grad():
        p_feats = pmodel.features(torch.tensor(images).permute(0, 3, 1, 2).contiguous())
        p_cls, p_reg = pmodel.head(p_feats, torch.tensor(rois), CANVAS_HW)
    assert p_cls.dtype == torch.float32 and p_cls.shape == (2, 24, NUM_CLASSES)
    _rel_close(p_cls.numpy(), np.asarray(j_cls))
    _rel_close(p_reg.numpy(), np.asarray(j_reg))

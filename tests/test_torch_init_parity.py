"""The port's fresh init against the JAX package's, distribution by distribution.

Every CLI of either package starts a run without weights from its
package's fresh init: the JAX ``main.init_params`` calls
``init_detector_params``, the port's ``utils/checkpoint.py::init_params``
calls ``init_detector_weights``. The two draw from different streams, so
the weights differ, but their distributions must not. Both generations, 4
classes, ``--seed 5`` through the port's ``init_params`` and
``jax.random.key(5)`` on the JAX side; the JAX params are mapped to the
port's layout by ``utils/convert.py`` (transposes and the fc6 pool
permutation only, which move no value).

* Every conv and linear layer of at least 4096 weights: ``std *
  sqrt(fan_in)`` within ``max(2%, 4 sigma)`` of the JAX layer's, where
  sigma is the standard error of the difference of two sample stds of
  ``n`` weights, ``sqrt(2 (kurtosis - 1) / (4 n))`` (kurtosis 2.366 for a
  normal cut at +-2, 3 for a normal): 2% from about 27,000 weights up, at
  4096 (ResNet's ``layer1.0.conv1``) 5.2%. The He-normal init this
  replaces is 41% off on every such layer.
* The layers JAX leaves at flax's default (``lecun_normal``: a normal of
  std ``sqrt(1 / fan_in) / 0.8796`` cut at twice that std): ``max|w|``
  within the cut, in both packages.
* fc6, the largest layer: the two-sample Kolmogorov-Smirnov distance of
  seeded subsamples of 10^6 weights under 0.01 (two draws of one
  distribution give about 0.0012 at that size, 0.0019 at the 95th
  percentile).
* Each head (the RPN convs, the class and box heads): the std within
  ``max(2%, 4 sigma)`` of the JAX package's ``N(0, std)`` (0.01, 0.01,
  0.001), sigma as above for one sample.
* Biases exactly zero and FrozenBN the identity, in both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models.resnet import FrozenBatchNorm2d
from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import init_params
from faster_rcnn_pytorch_tpu_torch.utils.convert import (
    fpn_state_dict_from_jax,
    legacy_state_dict_from_jax,
)

NUM_CLASSES = 4
SEED = 5
TRUNC = 0.87962566103423978  # the std of a standard normal cut at +-2
KURTOSIS = {"truncated": 2.366, "normal": 3.0}
MIN_WEIGHTS = 4096
KS_SAMPLES = 10**6
FROM_JAX = {"legacy": legacy_state_dict_from_jax, "fpn": fpn_state_dict_from_jax}


def _std_tol(n: int, kind: str, samples: int) -> float:
    """``max(2%, 4 sigma)``: sigma the relative standard error of a sample
    std of ``n`` weights (``samples=1``) or of the difference of two."""
    return max(0.02, 4 * math.sqrt(samples * (KURTOSIS[kind] - 1) / (4 * n)))


@pytest.fixture(scope="module", params=["legacy", "fpn"])
def inits(request):
    """(generation, the port's model after ``init_params``, the JAX
    package's ``init_detector_params`` in the port's layout)."""
    generation = request.param
    jmodel, _ = jfr.build_model(generation, num_classes=NUM_CLASSES, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(SEED), canvas=64))
    want = FROM_JAX[generation](params)
    del params
    model, _ = pfr.build_model(generation, NUM_CLASSES)
    opts = load_options(["--model_generation", generation, "--seed", str(SEED)])
    assert init_params(model, opts) == f"fresh init with seed {SEED}"
    return generation, model, want


def _layers(model):
    """(name, module, is a head) of every conv and linear layer."""
    heads = model.head_stds()
    return [
        (name, m, m in heads)
        for name, m in model.named_modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
    ]


def test_default_layers_have_the_jax_scale_and_cut(inits):
    generation, model, want = inits
    checked = 0
    for name, m, head in _layers(model):
        if head:
            continue
        got, ref = m.weight.detach().numpy(), want[f"{name}.weight"].numpy()
        assert got.shape == ref.shape, name
        fan_in = got[0].size
        cut = 2 * math.sqrt(1.0 / fan_in) / TRUNC * (1 + 1e-6)
        assert np.abs(ref).max() <= cut, (name, "JAX", np.abs(ref).max(), cut)
        assert np.abs(got).max() <= cut, (name, np.abs(got).max(), cut)
        if got.size < MIN_WEIGHTS:
            continue
        r_got, r_ref = got.std() * math.sqrt(fan_in), ref.std() * math.sqrt(fan_in)
        tol = _std_tol(got.size, "truncated", 2)
        assert abs(r_got - r_ref) <= tol * r_ref, (name, r_got, r_ref, tol)
        checked += 1
    # VGG16's 12 convs past the first and fc6/fc7; ResNet50's 53 convs,
    # the FPN's 8 and fc6/fc7
    assert checked == {"legacy": 14, "fpn": 63}[generation]


def _ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.sort(a), np.sort(b)
    x = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, x, "right") / a.size - np.searchsorted(b, x, "right") / b.size).max())


def test_fc6_is_drawn_from_the_jax_distribution(inits):
    generation, model, want = inits
    got = model.classifier[0].weight.detach().numpy().ravel()
    ref = want["classifier.0.weight"].numpy().ravel()
    rs = np.random.RandomState(0)
    d = _ks_distance(got[rs.choice(got.size, KS_SAMPLES, replace=False)],
                     ref[rs.choice(ref.size, KS_SAMPLES, replace=False)])
    assert d < 0.01, (generation, d)


def test_heads_have_the_jax_stds(inits):
    generation, model, want = inits
    stds = model.head_stds()
    assert len(stds) == 5
    for name, m, head in _layers(model):
        if not head:
            continue
        ref = want[f"{name}.weight"].numpy()
        for what, w in (("port", m.weight.detach().numpy()), ("JAX", ref)):
            tol = _std_tol(w.size, "normal", 1)
            assert abs(w.std() - stds[m]) <= tol * stds[m], (name, what, w.std(), stds[m], tol)
    want_stds = {"rpn": 0.01, "cls_head": 0.01, "reg_head": 0.001}
    for m, std in stds.items():
        name = next(n for n, mod in model.named_modules() if mod is m)
        key = "rpn" if name.startswith("rpn.") else name.rsplit(".", 1)[1]
        assert std == want_stds[key], (name, std)


def test_biases_are_zero_and_frozen_bn_the_identity(inits):
    generation, model, want = inits
    n_bias = 0
    for name, m, _ in _layers(model):
        if m.bias is not None:
            n_bias += 1
            assert not m.bias.any() and not want[f"{name}.bias"].numpy().any(), name
    assert n_bias == {"legacy": 20, "fpn": 15}[generation]
    identity = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0, "running_var": 1.0}
    n_bn = 0
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            n_bn += 1
            for leaf, value in identity.items():
                k = f"{name}.{leaf}"
                assert torch.all(getattr(m, leaf) == value) and np.all(want[k].numpy() == value), k
    assert n_bn == {"legacy": 0, "fpn": 53}[generation]

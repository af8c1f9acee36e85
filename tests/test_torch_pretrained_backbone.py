"""The port's ImageNet backbone import against the JAX package's.

One torchvision-layout state dict a generation (VGG16 ``features.*`` with
``classifier.{0,3,6}``; ResNet50 ``conv1``/``bn1``/``layer*`` with
randomised FrozenBN statistics and ``fc.*``), built from plain
``torch.nn`` as ``tests/test_pretrained_backbone.py`` builds it (there is
no torchvision here), saved to a file and loaded by both packages'
``load_pretrained_backbone``:

* both start from the same detector: the port's seeded fresh init, which
  the JAX package receives through its own ``import_*_torch_params``, so
  after the import ``export_{legacy,fpn}_torch_state_dict`` of the JAX
  params must equal the port model's whole state dict exactly, the
  backbone from the file and everything else the fresh init;
* the imported backbones give the same feature maps on a 64x96 input:
  ``max|d| <= 1e-5 * max|f|`` per map, float32 with TF32 off (two conv
  stacks summing in different orders; the JAX package holds its own
  import to the torch modules at the same bound);
* a shape that differs raises ``ValueError`` naming the key and copies
  nothing; a ResNet50 file without ``num_batches_tracked`` (the published
  file has none) loads; an unknown generation raises; a reference
  detector of the other generation or class count raises, naming the
  generation, and leaves the model as it was.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from faster_rcnn_pytorch_tpu.models.resnet import ResNet50 as JaxResNet50
from faster_rcnn_pytorch_tpu.models.vgg import VGG16Features as JaxVGG16
from faster_rcnn_pytorch_tpu.utils import checkpoint as jck
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils import checkpoint as ck
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics
from tests.test_pretrained_backbone import TorchResNet50Body, build_torch_vgg16_features

CLASSES = {"legacy": 6, "fpn": 7}
INPUT_HW = (64, 96)


def torchvision_vgg16_state_dict(seed: int) -> dict:
    """torchvision ``vgg16`` layout: ``features.*`` and a (small)
    ``classifier.{0,3,6}``, which the import ignores."""
    torch.manual_seed(seed)
    model = build_torch_vgg16_features()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05)
    sd = dict(model.state_dict())
    for i, shape in ((0, (8, 16)), (3, (8, 8)), (6, (10, 8))):
        sd[f"classifier.{i}.weight"] = torch.randn(shape)
        sd[f"classifier.{i}.bias"] = torch.randn(shape[0])
    return sd


def torchvision_resnet50_state_dict(seed: int, batches_tracked: bool = True) -> dict:
    """torchvision ``resnet50`` layout with seeded convs and FrozenBN
    statistics and a (small) ``fc``."""
    torch.manual_seed(seed)
    model = TorchResNet50Body()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.Conv2d):
                m.weight.normal_(0, 0.05)
            if isinstance(m, tnn.BatchNorm2d):
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = {
        k: v for k, v in model.state_dict().items()
        if batches_tracked or not k.endswith("num_batches_tracked")
    }
    sd["fc.weight"], sd["fc.bias"] = torch.randn(10, 2048), torch.randn(10)
    return sd


FILES = {"legacy": torchvision_vgg16_state_dict, "fpn": torchvision_resnet50_state_dict}
PREFIX = {"legacy": "extractor.", "fpn": "backbone.body."}


@functools.lru_cache(maxsize=None)
def _fresh_state(generation: str) -> dict:
    model, _ = pfr.build_model(generation, CLASSES[generation])
    return pfr.init_weights(model, torch.Generator().manual_seed(3)).state_dict()


def fresh_model(generation: str, classes: int | None = None):
    """The seeded fresh init (built on the meta device and filled from a
    cached copy: the legacy FCs' default init alone takes seconds)."""
    if classes not in (None, CLASSES[generation]):
        return pfr.build_model(generation, classes)[0]
    with torch.device("meta"):
        model, _ = pfr.build_model(generation, CLASSES[generation])
    model = model.to_empty(device="cpu")
    model.load_state_dict(_fresh_state(generation), strict=True)
    return model.eval()


def _numpy(sd: dict) -> dict:
    return {k: v.numpy().copy() for k, v in sd.items()}  # the JAX importers keep views


@pytest.fixture(scope="module", params=["legacy", "fpn"])
def imported(request, tmp_path_factory):
    """(generation, the file's state dict, the port model after its import,
    the JAX params after theirs)."""
    set_numerics("float32")
    generation = request.param
    path = str(tmp_path_factory.mktemp(generation) / "backbone.pth")
    sd = FILES[generation](seed=11)
    torch.save(sd, path)
    model = fresh_model(generation)
    importer = jck.import_legacy_torch_params if generation == "legacy" else jck.import_fpn_torch_params
    params = importer(_numpy(model.state_dict()), CLASSES[generation])
    ck.load_pretrained_backbone(model, path, generation)
    params = jck.load_pretrained_backbone(params, path, generation)
    return generation, sd, model, params


def test_the_import_equals_the_jax_packages_exactly(imported):
    generation, sd, model, params = imported
    export = jck.export_legacy_torch_state_dict if generation == "legacy" else jck.export_fpn_torch_state_dict
    want = export(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k
    fresh = _fresh_state(generation)
    prefix = PREFIX[generation]
    from_file = {k for k in got if k.startswith(prefix) and not k.endswith("num_batches_tracked")}
    assert len(from_file) == (26 if generation == "legacy" else 265)
    for k in got:
        if k in from_file:  # extractor.{i}.* <- features.{i}.*, backbone.body.* <- *
            src = k.removeprefix(prefix)
            assert torch.equal(got[k], sd[f"features.{src}" if generation == "legacy" else src]), k
        else:
            assert torch.equal(got[k], fresh[k]), k


def test_the_imported_backbones_features_match_jax(imported):
    generation, _, model, params = imported
    x = np.random.RandomState(5).normal(size=(1, *INPUT_HW, 3)).astype(np.float32)
    with torch.no_grad():
        if generation == "legacy":
            got = [model.extractor(torch.from_numpy(x.transpose(0, 3, 1, 2)))]
            want = [JaxVGG16(dtype=jnp.float32).apply({"params": params["params"]["extractor"]}, x)]
        else:
            got = model.backbone.body(torch.from_numpy(x.transpose(0, 3, 1, 2)))
            want = JaxResNet50(dtype=jnp.float32).apply(
                {"params": params["params"]["backbone"]["body"]}, x
            )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        rel = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert rel <= 1e-5, rel


def test_a_shape_that_differs_raises_and_copies_nothing(tmp_path):
    sd = torchvision_vgg16_state_dict(seed=12)
    sd["features.28.weight"] = torch.zeros(512, 512, 5, 5)
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    model = fresh_model("legacy")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=r"shape mismatch.*extractor\.28\.weight"):
        ck.load_pretrained_backbone(model, path, "legacy")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_a_resnet50_file_without_num_batches_tracked_loads(tmp_path):
    sd = torchvision_resnet50_state_dict(seed=13, batches_tracked=False)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    model = fresh_model("fpn")
    ck.load_pretrained_backbone(model, path, "fpn")
    got = model.state_dict()
    assert torch.equal(got["backbone.body.layer4.2.bn3.running_var"], sd["layer4.2.bn3.running_var"])
    assert torch.equal(got["backbone.body.conv1.weight"], sd["conv1.weight"])


def test_an_unknown_generation_raises(tmp_path):
    path = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_vgg16_state_dict(seed=14), path)
    with pytest.raises(ValueError, match="unknown generation"):
        ck.load_pretrained_backbone(fresh_model("fpn"), path, "vgg")


@pytest.mark.parametrize(
    "file_generation,file_classes,generation,classes",
    [("legacy", 6, "fpn", 7), ("fpn", 7, "fpn", 8), ("fpn", 7, "legacy", 6)],
)
def test_a_detector_of_another_generation_raises(tmp_path, file_generation, file_classes, generation, classes):
    path = str(tmp_path / "frcnn.best.pth.tar")
    ck.save_torch_checkpoint(path, fresh_model(file_generation, file_classes))
    model = fresh_model(generation, classes)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=f"not a {generation} detector of {classes} classes"):
        ck.load_reference_weights(model, path, generation)
    os.remove(path)  # up to 1 GB
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k

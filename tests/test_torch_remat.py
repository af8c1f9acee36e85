"""``--remat_backbone`` in the port: the same losses and gradients, bit for bit.

The counterpart of the JAX package's ``test_remat_backbone_matches_no_remat``
and ``test_remat_fpn_backbone_matches_no_remat``: one float32 train step of
each generation, with the backbone checkpointed (VGG16 whole, ResNet50 per
bottleneck: ``torch.utils.checkpoint``) and without, on the same weights,
batch and sampling noise (the set-up of ``tests/torch_dist_workers.py``),
must give identical losses and parameter gradients; the checkpointed
modules are the ones the JAX package rematerialises, and predict (no
gradient) runs them straight.
"""

import pytest
import torch

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models.resnet import Bottleneck
from faster_rcnn_pytorch_tpu_torch.models.vgg import VGG16Features
from tests import torch_dist_workers as w


def _step(generation: str, remat: bool):
    model = w.new_model(generation, remat=remat)
    batch = w.rows(w.make_batch(2, generation=generation), 0, 2)
    out = pfr.forward_train(
        model, w.CONFIGS[generation], *(batch[k] for k in w.KEYS),
        generator=torch.Generator().manual_seed(5),
    )
    out.losses.total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return model, out.losses, grads


@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_remat_matches_no_remat(generation):
    model, losses, grads = _step(generation, True)
    _, want_losses, want_grads = _step(generation, False)
    kind = VGG16Features if generation == "legacy" else Bottleneck
    remat = [m for m in model.modules() if getattr(m, "remat", False)]
    assert remat and all(isinstance(m, kind) for m in remat)
    assert len(remat) == (1 if generation == "legacy" else 16)
    for a, b in zip(losses, want_losses):
        assert torch.equal(a, b)
    assert grads.keys() == want_grads.keys() and grads
    for k, g in grads.items():
        assert torch.equal(g, want_grads[k]), k

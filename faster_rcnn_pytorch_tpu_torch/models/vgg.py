"""VGG16 feature extractor (legacy-generation backbone), NCHW.

Counterpart of ``faster_rcnn_pytorch_tpu/models/vgg.py``: the 13 convs of
VGG16 with ReLU and a 2x2 max-pool between stages, the last pool dropped
(stride 16, 512 channels). It is torchvision's ``vgg16().features[:-1]``
layout, so the parameters are named ``{i}.weight`` / ``{i}.bias`` at
:data:`TORCH_VGG16_CONV_INDICES`. The JAX package's slab-batched stem is
a train-only TPU schedule and is not on the predict path; this is the
plain stack.

``remat`` (``--remat_backbone``) checkpoints the stack whole, as the JAX
package's ``nn.remat(VGG16Features)``: its activations are dropped in the
forward and recomputed in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

# (channels, convs in stage); a max-pool follows each stage except the last.
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# torchvision vgg16().features indices of the 13 convs, in order.
TORCH_VGG16_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class VGG16Features(nn.Sequential):
    """``[B, 3, H, W]`` -> ``[B, 512, H//16, W//16]``."""

    def __init__(self):
        layers: list[nn.Module] = []
        in_ch = 3
        for stage, (ch, n_convs) in enumerate(VGG16_STAGES):
            for _ in range(n_convs):
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU(inplace=True)]
                in_ch = ch
            if stage < len(VGG16_STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        self.remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(super().forward, x, use_reentrant=False)
        return super().forward(x)

"""ResNet50 + FPN backbone of the FPN generation, NCHW.

Counterpart of ``faster_rcnn_pytorch_tpu/models/resnet.py`` (torchvision's
``resnet_fpn_backbone('resnet50')``). Module names follow the reference
layout that ``export_fpn_torch_state_dict`` writes
(``backbone.body.layer1.0.conv1``, ``backbone.fpn.inner_blocks.0.0``, ...),
so its state dict loads with ``strict=True``.

* :class:`FrozenBatchNorm2d` keeps constant statistics as float32 buffers
  and computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in that
  order, with the fold ``rsqrt(var + eps) * scale`` in float32 and cast to
  the activations' dtype afterwards, as the JAX module does (not
  torchvision's ``x * scale + (bias - mean * scale)``).
* The stride of a down-sampling bottleneck is on its 3x3 conv.
* The FPN's top-down path upsamples with ``nearest-exact``: the JAX
  package's ``jax.image.resize(..., "nearest")`` samples
  ``floor((i + 0.5) * in / out)``, which PyTorch's ``"nearest"``
  (``floor(i * in / out)``) does not when a level is not exactly twice the
  next (odd ``H / 16``).
* P6 is ``max_pool2d(P5, 1, 2)`` (``LastLevelMaxPool``); it feeds the RPN only.
* The stem and ``layer1`` are frozen (the JAX package's ``frozen_stages=2``,
  torchvision's ``trainable_layers=3``): the activations are detached after
  the stem's max pool and after ``layer1``, in every mode, as JAX's
  ``stop_gradient``. Their weights get no gradient from the loss; the
  optimizer still decays them (``parallel/train_step.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = (3, 4, 6, 3)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with constant statistics, all held as buffers (no
    gradient, and ``num_batches_tracked`` so a reference state dict loads
    strictly). The buffers stay float32 in a bfloat16 model
    (``utils.runtime.prepare_for_inference``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()

        def col(t):
            return t.to(x.dtype)[None, :, None, None]

        return (x - col(self.running_mean)) * col(inv) + col(self.bias)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 residual block with expansion 4."""

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = None
        if cin != width * 4 or stride != 1:
            self.downsample = nn.Sequential(
                _conv(cin, width * 4, 1, stride), FrozenBatchNorm2d(width * 4)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """The body: ``[B, 3, H, W]`` -> C2..C5 at strides 4, 8, 16, 32, with
    the stem and ``layer1`` frozen."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for stage, blocks in enumerate(STAGE_SIZES):
            width = 64 * 2**stage
            layers = []
            for b in range(blocks):
                layers.append(Bottleneck(cin, width, 2 if (b == 0 and stage > 0) else 1))
                cin = width * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1).detach()  # frozen stem
        feats = []
        for stage in range(len(STAGE_SIZES)):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage == 0:
                x = x.detach()  # frozen layer1
            feats.append(x)
        return tuple(feats)


class FPN(nn.Module):
    """C2..C5 -> P2..P5 (1x1 laterals, nearest top-down, 3x3 outputs),
    plus P6 by a stride-2 max pool of P5."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, out_channels, 1)) for c in in_channels
        )
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in in_channels
        )

    def forward(self, feats) -> tuple[torch.Tensor, ...]:
        laterals = [block(f) for block, f in zip(self.inner_blocks, feats)]
        out = [laterals[-1]]
        for lat in reversed(laterals[:-1]):
            up = F.interpolate(out[0], size=lat.shape[-2:], mode="nearest-exact")
            out.insert(0, lat + up)
        pyramid = [block(f) for block, f in zip(self.layer_blocks, out)]
        return (*pyramid, F.max_pool2d(pyramid[-1], 1, stride=2))


class ResNet50FPN(nn.Module):
    """Image ``[B, 3, H, W]`` -> (P2, P3, P4, P5, P6), 256 channels each."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50()
        self.fpn = FPN()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.fpn(self.body(x))

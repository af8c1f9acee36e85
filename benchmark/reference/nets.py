"""Plain PyTorch networks of both Faster R-CNN generations.

Written from the published architectures (Ren et al. 2015: VGG16 conv5_3,
a 3x3 RPN conv and two 1x1 heads, RoIPool 7x7 and fc6/fc7 of 4096; Lin et
al. 2017: ResNet50 with frozen batch norm, an FPN of 256 channels, P6 by
a stride-2 pool, MultiScaleRoIAlign 7x7 and a two-layer MLP of 1024). The
parameter names are the reference implementations' state-dict names, so
one seeded weight dictionary fills these modules and the program's alike.

Every convolution and linear layer calls :class:`Numerics`, which runs it
as stated (``"stated"``) or, for the benchmark's control, with inputs and
weights rounded to float8 e4m3 under a per-tensor scale (``"fp8"``).
Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


class _FakeQuant(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor amax scale and back, with a
    straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().float().clamp(min=1e-12) / E4M3_MAX
        q = (x.float() / scale).to(torch.float8_e4m3fn)
        return (q.float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


class Numerics:
    """How the reference multiplies: ``"stated"`` (the configuration's own
    precision) or ``"fp8"`` (the control)."""

    def __init__(self, mode: str = "stated"):
        if mode not in ("stated", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def _q(self, t):
        if self.mode == "stated" or t is None:
            return t
        if torch.is_autocast_enabled(t.device.type) and t.is_floating_point():
            t = t.to(torch.get_autocast_dtype(t.device.type))
        return _FakeQuant.apply(t)

    def conv(self, m: nn.Conv2d, x):
        return F.conv2d(self._q(x), self._q(m.weight), m.bias, m.stride, m.padding)

    def linear(self, m: nn.Linear, x):
        return F.linear(self._q(x), self._q(m.weight), m.bias)


class Conv(nn.Conv2d):
    def __init__(self, *args, num: Numerics, **kwargs):
        super().__init__(*args, **kwargs)
        self.num = num

    def forward(self, x):
        return self.num.conv(self, x)


class Linear(nn.Linear):
    def __init__(self, *args, num: Numerics, **kwargs):
        super().__init__(*args, **kwargs)
        self.num = num

    def forward(self, x):
        return self.num.linear(self, x)


class VGG16(nn.Sequential):
    """The 13 convs of VGG16 with ReLU and a 2x2 max pool between the five
    stages, the last pool dropped: stride 16, 512 channels. Indices are
    torchvision's ``vgg16().features``."""

    def __init__(self, num: Numerics):
        layers: list[nn.Module] = []
        cin = 3
        for stage, (ch, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))):
            for _ in range(n):
                layers += [Conv(cin, ch, 3, padding=1, num=num), nn.ReLU()]
                cin = ch
            if stage < 4:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)


class FrozenBN(nn.Module):
    """Constant batch statistics: ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, the fold taken in float32 and cast to ``x``'s dtype."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), value))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()

        def col(t):
            return t.to(x.dtype)[None, :, None, None]

        return (x - col(self.running_mean)) * col(inv) + col(self.bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, num: Numerics):
        super().__init__()
        self.conv1 = Conv(cin, width, 1, bias=False, num=num)
        self.bn1 = FrozenBN(width)
        self.conv2 = Conv(width, width, 3, stride=stride, padding=1, bias=False, num=num)
        self.bn2 = FrozenBN(width)
        self.conv3 = Conv(width, width * 4, 1, bias=False, num=num)
        self.bn3 = FrozenBN(width * 4)
        self.downsample = None
        if cin != width * 4 or stride != 1:
            self.downsample = nn.Sequential(
                Conv(cin, width * 4, 1, stride=stride, bias=False, num=num), FrozenBN(width * 4)
            )

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet50Body(nn.Module):
    """C2..C5; the stem and layer1 frozen (their outputs detached)."""

    def __init__(self, num: Numerics):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False, num=num)
        self.bn1 = FrozenBN(64)
        cin = 64
        for stage, blocks in enumerate((3, 4, 6, 3)):
            width = 64 * 2**stage
            layers = []
            for b in range(blocks):
                layers.append(Bottleneck(cin, width, 2 if (b == 0 and stage > 0) else 1, num))
                cin = width * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1).detach()
        feats = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage == 0:
                x = x.detach()
            feats.append(x)
        return feats


class FPN(nn.Module):
    """1x1 laterals, nearest top-down sums (``floor((i + 0.5) * in / out)``
    sampling), 3x3 outputs, and P6 as a 1x1 stride-2 max pool of P5."""

    def __init__(self, num: Numerics):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(Conv(c, 256, 1, num=num)) for c in (256, 512, 1024, 2048)
        )
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(Conv(256, 256, 3, padding=1, num=num)) for _ in range(4)
        )

    def forward(self, feats):
        lats = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        out = [lats[-1]]
        for lat in reversed(lats[:-1]):
            out.insert(0, lat + F.interpolate(out[0], size=lat.shape[-2:], mode="nearest-exact"))
        pyramid = [blk(f) for blk, f in zip(self.layer_blocks, out)]
        return (*pyramid, F.max_pool2d(pyramid[-1], 1, stride=2))


class Backbone(nn.Module):
    def __init__(self, num: Numerics):
        super().__init__()
        self.body = ResNet50Body(num)
        self.fpn = FPN(num)

    def forward(self, x):
        return self.fpn(self.body(x))


class RPNHead(nn.Module):
    """3x3 conv + ReLU, 1x1 objectness (2A) and deltas (4A), flattened in
    (y, x, anchor) order, returned in float32."""

    def __init__(self, anchors: int, channels: int, num: Numerics):
        super().__init__()
        self.inter_layer = Conv(channels, channels, 3, padding=1, num=num)
        self.cls_layer = Conv(channels, anchors * 2, 1, num=num)
        self.reg_layer = Conv(channels, anchors * 4, 1, num=num)

    def forward(self, feat):
        x = torch.relu(self.inter_layer(feat))
        b = feat.shape[0]
        cls = self.cls_layer(x).permute(0, 2, 3, 1).reshape(b, -1, 2)
        reg = self.reg_layer(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return cls.float(), reg.float()


class Head(nn.Module):
    """The shared fc trunk, then class scores and per-class deltas."""

    def __init__(self, classifier: nn.Sequential, width: int, classes: int, num: Numerics):
        super().__init__()
        self.classifier = classifier
        self.cls_head = Linear(width, classes, num=num)
        self.reg_head = Linear(width, classes * 4, num=num)

    def forward(self, pooled):
        b, s = pooled.shape[:2]
        x = self.classifier(pooled.reshape(b, s, -1))
        return self.cls_head(x).float(), self.reg_head(x).float()


def _trunk(cin: int, width: int, num: Numerics) -> nn.Sequential:
    return nn.Sequential(
        Linear(cin, width, num=num), nn.ReLU(), Linear(width, width, num=num), nn.ReLU()
    )


class LegacyNet(nn.Module):
    generation = "legacy"

    def __init__(self, classes: int, num: Numerics):
        super().__init__()
        self.extractor = VGG16(num)
        self.rpn = RPNHead(9, 512, num)
        self.classifier = _trunk(512 * 49, 4096, num)
        self.fast_rcnn_head = Head(self.classifier, 4096, classes, num)

    def features(self, images):
        return self.extractor(images)

    def rpn_out(self, feats):
        return self.rpn(feats)

    def head(self, pooled):
        return self.fast_rcnn_head(pooled)


class FPNNet(nn.Module):
    generation = "fpn"

    def __init__(self, classes: int, num: Numerics):
        super().__init__()
        self.backbone = Backbone(num)
        self.rpn = nn.ModuleDict({"rpn_head": RPNHead(3, 256, num)})
        self.classifier = _trunk(256 * 49, 1024, num)
        self.frcnn_head = Head(self.classifier, 1024, classes, num)

    def features(self, images):
        return self.backbone(images)

    def rpn_out(self, feats):
        outs = [self.rpn["rpn_head"](f) for f in feats]
        return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)

    def head(self, pooled):
        return self.frcnn_head(pooled)


def build(generation: str, classes: int, numerics: str = "stated") -> nn.Module:
    num = Numerics(numerics)
    if generation == "legacy":
        return LegacyNet(classes, num)
    if generation == "fpn":
        return FPNNet(classes, num)
    raise ValueError(f"unknown generation {generation!r}")

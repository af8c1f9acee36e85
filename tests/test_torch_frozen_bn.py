"""The FrozenBN site as one op (``ops/frozen_bn.py``): FrozenBatchNorm2d
with the residual add and the ReLU where the site has them.

On the CPU: the op's plain path (the ``frcnn::frozen_bn`` op without a
gradient, the autograd function with one) equals the expressions
``models/resnet.py`` ran before the op, bit for bit, forward and backward;
a residual without the ReLU, a kind of site the model does not have,
raises;
the op's schema and fake implementation (``opcheck``); a checkpointed
bottleneck through the autograd function equals the plain one; the
ResNet50-FPN trunk calls the op at its 53 sites, of which the backward
reaches 42 (layers 2-4); an exported trunk calls it by name.

On a card (marked ``card``, skipped without one): the kernel equals the
eager chain bit for bit, forward and backward (the input's and the
residual's gradients), in bfloat16 and float32, for the three kinds of
site, at every ResNet50 level of the 800x1344 and 320x512 canvases
(layer 4's 25x42 planes are not a multiple of 8 elements) and on bases
off a 16-byte boundary; a FPN train step launches the forward 53 times
and the backward 42 times, a legacy step neither. NaN payloads are not
compared: a NaN must be a NaN on both sides. This file imports no JAX, so
on the card::

    python -m pytest --noconftest tests/test_torch_frozen_bn.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.models.resnet import Bottleneck, FrozenBatchNorm2d, ResNet50FPN
from faster_rcnn_pytorch_tpu_torch.ops import frozen_bn as fbn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (residual, relu): the stem's and every block's bn1 and bn2; every bn3; downsample.1
SITES = {"bn_relu": (False, True), "bn_residual_relu": (True, True), "bn": (False, False)}


def _pre_change_chain(x, bn: FrozenBatchNorm2d, residual=None, relu=False):
    """What ``models/resnet.py`` computed before the op, verbatim."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()

    def col(t):
        return t.to(x.dtype)[None, :, None, None]

    y = (x - col(bn.running_mean)) * col(inv) + col(bn.bias)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _seeded_bn(c: int, seed: int) -> FrozenBatchNorm2d:
    """Statistics with negative scales and signed zero biases."""
    g = torch.Generator().manual_seed(seed)
    bn = FrozenBatchNorm2d(c)
    bn.weight.copy_(torch.randn(c, generator=g))
    bn.bias.copy_(torch.randn(c, generator=g) * 0.5)
    bn.bias[::4] = 0.0
    bn.bias[1::4] = -0.0
    bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
    bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
    return bn


def _site_inputs(shape, dtype, seed: int, residual: bool, nan: bool = True):
    """``x`` (a row of each plane equal to its channel's mean: zeros before
    a negative scale; a NaN and infinities), the residual or None, and
    the upstream gradient, on the CPU in float32 (cast by the caller)."""
    g = torch.Generator().manual_seed(seed)
    bn = _seeded_bn(shape[1], seed)
    x = torch.randn(shape, generator=g) * 2
    x[:, :, 0, :] = bn.running_mean[None, :, None]
    if nan:
        x.view(-1)[1] = float("nan")
    x.view(-1)[2] = float("inf")
    x.view(-1)[3] = -float("inf")
    r = torch.randn(shape, generator=g) * 2 if residual else None
    grad = torch.randn(shape, generator=g).to(dtype)
    return bn, x.to(dtype), None if r is None else r.to(dtype), grad


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs aside: the same NaN positions, equal bits elsewhere."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return False
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.masked_fill(nan_a, 0).view(bits), b.masked_fill(nan_b, 0).view(bits))


def _run(fn, x, r, grad, bn, relu):
    """``fn``'s output and the gradients of ``x`` and the residual."""
    x = x.detach().requires_grad_()
    r = None if r is None else r.detach().requires_grad_()
    y = fn(x, bn, r, relu)
    y.backward(grad)
    return y.detach(), x.grad, None if r is None else r.grad


def _module_site(x, bn, residual=None, relu=False):
    return bn(x, residual, relu=relu)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
def test_cpu_path_equals_pre_change_chain(dtype, site):
    residual, relu = SITES[site]
    bn, x, r, grad = _site_inputs((2, 12, 5, 7), DTYPES[dtype], 3, residual)
    with torch.no_grad():  # the frcnn::frozen_bn op
        assert _same(_module_site(x, bn, r, relu), _pre_change_chain(x, bn, r, relu))
    got = _run(_module_site, x, r, grad, bn, relu)  # the autograd function
    want = _run(_pre_change_chain, x, r, grad, bn, relu)
    for a, b in zip(got, want):
        assert (a is None and b is None) or _same(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
def test_op_schema_and_fake(dtype, site):
    residual, relu = SITES[site]
    bn, x, r, _ = _site_inputs((2, 4, 3, 5), DTYPES[dtype], 1, residual, nan=False)
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    torch.library.opcheck(
        torch.ops.frcnn.frozen_bn.default,
        (x, bn.running_mean, inv, bn.bias, r, relu),
        test_utils=("test_schema", "test_autograd_registration", "test_faketensor"),
    )


@pytest.mark.parametrize("grad", [False, True], ids=["op", "autograd"])
def test_residual_without_relu_raises(grad):
    bn, x, r, _ = _site_inputs((2, 4, 3, 5), torch.float32, 2, True, nan=False)
    x.requires_grad_(grad)
    with pytest.raises(ValueError, match="a residual has a ReLU"):
        bn(x, r, relu=False)


def test_module_keeps_its_buffers():
    bn = FrozenBatchNorm2d(8)
    assert list(bn.state_dict()) == [
        "weight", "bias", "running_mean", "running_var", "num_batches_tracked",
    ]
    assert not list(bn.parameters())


def _seeded_bottleneck(cin: int, width: int, stride: int, remat: bool) -> Bottleneck:
    torch.manual_seed(0)
    block = Bottleneck(cin, width, stride)
    for i, m in enumerate(block.modules()):
        if isinstance(m, FrozenBatchNorm2d):
            seeded = _seeded_bn(m.weight.numel(), 10 + i)
            m.load_state_dict(seeded.state_dict())
    block.remat = remat
    return block


@pytest.mark.parametrize("cin,stride", [(32, 1), (16, 2)], ids=["identity", "downsample"])
def test_remat_bottleneck_equals_plain(cin, stride):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, cin, 9, 11, generator=g)
    grad = torch.randn(2, 32, 9 // stride + 9 % stride, 11 // stride + 11 % stride, generator=g)
    results = []
    for remat in (True, False):
        block = _seeded_bottleneck(cin, 8, stride, remat)
        xi = x.clone().requires_grad_()
        y = block(xi)
        y.backward(grad)
        results.append((y.detach(), xi.grad, [p.grad for p in block.parameters()]))
    (y1, dx1, g1), (y2, dx2, g2) = results
    assert torch.equal(y1, y2) and torch.equal(dx1, dx2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert len(g1) == (3 if stride == 1 else 4)


class _CountOp(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.frcnn.frozen_bn.default:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def _backward_sites(outputs) -> int:
    """The autograd function's nodes the outputs' backward reaches."""
    seen, stack, n = set(), [t.grad_fn for t in outputs], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        n += type(node).__name__ == "_FrozenBNBackward"
        stack.extend(nxt for nxt, _ in node.next_functions)
    return n


def test_trunk_sites_forward_53_backward_42():
    torch.manual_seed(0)
    trunk = ResNet50FPN()
    x = torch.randn(1, 3, 64, 96)
    with torch.no_grad(), _CountOp() as count:
        trunk(x)
    assert count.calls == 53
    assert _backward_sites(trunk(x)) == 42  # the stem and layer1 are detached


def test_exported_trunk_calls_the_op_by_name():
    torch.manual_seed(0)
    trunk = ResNet50FPN().eval()
    x = torch.randn(1, 3, 64, 96)
    with torch.no_grad():
        exported = torch.export.export(trunk, (x,))
        want = trunk(x)
    nodes = [n for n in exported.graph.nodes if n.target is torch.ops.frcnn.frozen_bn.default]
    assert len(nodes) == 53
    got = exported.module()(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


# (stride, channels of a bn1/bn2 site): the stem and layers 1-4; bn3 and
# downsample.1 have 4x the channels (the stem has neither)
LEVELS = {
    "stem": (2, 64), "layer1": (4, 64), "layer2": (8, 128), "layer3": (16, 256), "layer4": (32, 512),
}
CANVASES = {"800x1344": (800, 1344), "320x512": (320, 512)}


def _level_shape(canvas: str, level: str, site: str, batch: int = 2):
    (h, w), (stride, width) = CANVASES[canvas], LEVELS[level]
    c = width if site == "bn_relu" or level == "stem" else 4 * width
    return batch, c, -(-h // stride), -(-w // stride)


def _check_kernel(bn, x, r, grad, relu, device):
    bn = bn.to(device)
    x, grad = x.to(device), grad.to(device)
    r = None if r is None else r.to(device)
    before = fbn.frozen_bn_cuda.launches, fbn.frozen_bn_backward_cuda.launches
    got = _run(_module_site, x, r, grad, bn, relu)
    want = _run(_pre_change_chain, x, r, grad, bn, relu)
    torch.cuda.synchronize()
    assert (fbn.frozen_bn_cuda.launches, fbn.frozen_bn_backward_cuda.launches) == (
        before[0] + 1, before[1] + 1,
    )
    for name, a, b in zip(("y", "dx", "dresidual"), got, want):
        assert (a is None and b is None) or _same(a, b), name
    with torch.no_grad():  # the frcnn::frozen_bn op
        assert _same(_module_site(x, bn, r, relu), want[0])


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("canvas", list(CANVASES))
def test_kernel_equals_eager_chain(canvas, level, site, dtype):
    device = _card()
    residual, relu = SITES[site]
    bn, x, r, grad = _site_inputs(_level_shape(canvas, level, site), DTYPES[dtype], 7, residual)
    _check_kernel(bn, x, r, grad, relu, device)


def _off_boundary(t: torch.Tensor) -> torch.Tensor:
    """``t`` at a base one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
def test_kernel_on_bases_off_a_boundary(site, dtype):
    device = _card()
    residual, relu = SITES[site]
    shape = _level_shape("800x1344", "layer4", site)
    bn, x, r, grad = _site_inputs(shape, DTYPES[dtype], 9, residual)
    x, grad = _off_boundary(x.to(device)), _off_boundary(grad.to(device))
    r = None if r is None else _off_boundary(r.to(device))
    assert x.data_ptr() % 16 != 0
    _check_kernel(bn, x, r, grad, relu, device)


def _train_step(generation: str, device):
    """One float32 train step of ``generation`` on a seeded batch of 2 at
    192x256, 3 gt boxes an image; the forward's FrozenBN launches."""
    cfg = pfr.LEGACY_CONFIG if generation == "legacy" else pfr.FPN_CONFIG
    cfg = dataclasses.replace(
        cfg, num_classes=6, pre_nms_train=256, post_nms_train=64, roi_samples=32, roi_pos_quota=8
    )
    model, _ = pfr.build_model(generation, 6)
    pfr.init_weights(model, torch.Generator().manual_seed(0))
    model.to(device)
    rs = np.random.RandomState(0)
    xy = rs.uniform(0.02, 0.5, size=(2, 3, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0.15, 0.4, size=(2, 3, 2))], -1)
    batch = (
        rs.normal(size=(2, 192, 256, 3)),
        np.ones((2, 2)),
        boxes,
        rs.randint(1, 5, size=(2, 3)).astype(np.int32),
        np.ones((2, 3), bool),
    )
    batch = [torch.from_numpy(a).to(device) for a in batch]
    batch[:3] = [t.float() for t in batch[:3]]
    out = pfr.forward_train(model, cfg, *batch, generator=torch.Generator(device).manual_seed(5))
    fwd = fbn.frozen_bn_cuda.launches
    out.losses.total.backward()
    torch.cuda.synchronize()
    return fwd


@pytest.mark.card
def test_launches_fpn_step_53_and_42_legacy_none():
    device = _card()
    fwd, bwd = fbn.frozen_bn_cuda, fbn.frozen_bn_backward_cuda
    f0, b0 = fwd.launches, bwd.launches
    assert _train_step("fpn", device) - f0 == 53
    assert bwd.launches - b0 == 42
    f1, b1 = fwd.launches, bwd.launches
    _train_step("legacy", device)
    assert (fwd.launches, bwd.launches) == (f1, b1)

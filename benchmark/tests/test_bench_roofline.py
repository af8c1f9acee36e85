"""Work counts: the FLOP counter against a hand count, and the kernels'
byte bounds against the kernel table of PERF.md."""

import pytest
import torch

from benchmark.reference.nets import build
from benchmark.roofline import work
from benchmark.roofline.kernels import roi_pool_fwd
from benchmark.roofline.flops import StepFlops


def vgg16_hand_count(h: int, w: int) -> int:
    total, cin = 0, 3
    for stage, (ch, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))):
        for _ in range(n):
            total += 2 * h * w * ch * cin * 9
            cin = ch
        if stage < 4:
            h, w = h // 2, w // 2
    return total


def test_vgg16_conv_stack_flops_at_800x1344():
    net = build("legacy", 21).to("meta")
    with StepFlops(net.extractor) as f:
        net.extractor(torch.empty((1, 3, 800, 1344), device="meta"))
    assert f.total == vgg16_hand_count(800, 1344)
    assert f.total == pytest.approx(657.7e9, rel=1e-3)


def test_train_step_counts_backward_where_it_runs():
    """Forward, input and weight gradients: the first conv gets no input
    gradient (the image needs none), a detached layer no backward."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.ReLU(), torch.nn.Conv2d(4, 4, 1))
    frozen = torch.nn.Conv2d(3, 4, 1)
    x = torch.randn(1, 3, 8, 8)
    fwd = 2 * 64 * 4 * 3 * 9 + 2 * 64 * 4 * 4
    with StepFlops(net) as f, StepFlops(frozen) as g:
        (net(x).sum() + frozen(x).detach().sum() * 0).backward()
    assert f.total == fwd + 2 * 64 * 4 * 3 * 9 * 1 + 2 * 64 * 4 * 4 * 2
    assert g.total == 2 * 64 * 4 * 3


def test_roi_pool_bytes_reproduce_the_kernel_table_row_1():
    """Legacy predict: [1, 512, 50, 84] float32 map (8.60 MB) and 300 rois
    of 512 x 7 x 7 float32 out (30.11 MB): a bound of 0.0116 ms."""
    feats, rois = torch.empty((1, 512, 50, 84)), torch.empty((1, 300, 4))
    ops, nbytes = roi_pool_fwd.count(feats, rois)
    assert feats.numel() * 4 / 1e6 == pytest.approx(8.60, abs=0.005)
    assert (nbytes - feats.numel() * 4 - rois.numel() * 4) / 1e6 == pytest.approx(30.11, abs=0.005)
    assert work.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.0116, abs=0.00005)


def test_every_work_item_has_a_counter_and_kernels():
    import importlib

    found = work.items()
    assert len(found) == 7
    for item, mod in found.items():
        assert callable(mod.count) and mod.KERNELS
        module, fn = mod.FUNCTION.split(":")
        assert module.startswith("faster_rcnn_pytorch_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), fn))

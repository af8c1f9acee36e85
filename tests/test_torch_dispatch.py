"""The one choice of kernel: ``ops/library.py::use_kernel`` and its switch.

* No function of the port takes a ``plain`` flag (an AST scan of every
  module of ``faster_rcnn_pytorch_tpu_torch/``: no parameter, keyword
  argument or attribute of that name), and no ``frcnn::*`` op schema has a
  ``plain`` argument: the choice is made in one place.
* ``use_kernel``: a CPU tensor takes the plain version; any other device
  but CUDA raises outside ``plain_versions()`` and takes the plain version
  inside it.
* ``plain_versions()`` is restored when its ``with`` ends, by an
  exception too.
* An autograd function's backward takes the path its forward took, also
  when the switch has changed in between (CUDA's backward runs on a thread
  that does not see it): the kernel wrappers are spies around the plain
  versions here.
"""

import ast
import contextlib
import os

import pytest
import torch

import faster_rcnn_pytorch_tpu_torch
from faster_rcnn_pytorch_tpu_torch.ops import frozen_bn as fbn
from faster_rcnn_pytorch_tpu_torch.ops import library
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra
from faster_rcnn_pytorch_tpu_torch.ops import roi_pool as prp

PACKAGE = os.path.dirname(faster_rcnn_pytorch_tpu_torch.__file__)


def _plain_names(source: str) -> list[str]:
    """Every parameter, keyword argument and attribute named ``plain``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.arguments):
            args = node.posonlyargs + node.args + node.kwonlyargs + [node.vararg, node.kwarg]
            found += [f"parameter, line {a.lineno}" for a in args if a is not None and a.arg == "plain"]
        elif isinstance(node, ast.keyword) and node.arg == "plain":
            found.append(f"keyword, line {node.lineno}")
        elif isinstance(node, ast.Attribute) and node.attr == "plain":
            found.append(f"attribute, line {node.lineno}")
    return found


def test_no_function_of_the_port_takes_a_plain_flag():
    assert sorted(_plain_names("def f(x, plain=False):\n    return g(x, plain=plain), ctx.plain\n")) == [
        "attribute, line 2", "keyword, line 2", "parameter, line 1",
    ]
    found = {}
    for base, _, names in os.walk(PACKAGE):
        for name in sorted(n for n in names if n.endswith(".py")):
            path = os.path.join(base, name)
            with open(path) as f:
                if hits := _plain_names(f.read()):
                    found[os.path.relpath(path, PACKAGE)] = hits
    assert found == {}


@pytest.mark.parametrize("op", ["roi_pool", "multiscale_roi_align", "nms_segments", "frozen_bn"])
def test_op_schemas_take_no_plain_argument(op):
    schema = getattr(torch.ops.frcnn, op).default._schema
    assert "plain" not in [a.name for a in schema.arguments], str(schema)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
def test_use_kernel(device, inside):
    t = torch.empty(2, device=device)
    with library.plain_versions() if inside else contextlib.nullcontext():
        if device == "meta" and not inside:
            with pytest.raises(NotImplementedError, match="no RoIPool kernel for meta"):
                library.use_kernel(t, "RoIPool")
        else:
            assert library.use_kernel(t, "RoIPool") is False


@pytest.mark.parametrize("fail", [False, True], ids=["normal_exit", "exception"])
def test_plain_versions_is_restored_on_exit(fail):
    meta = torch.empty(2, device="meta")
    with contextlib.suppress(RuntimeError):
        with library.plain_versions():
            with library.plain_versions():
                assert library.use_kernel(meta, "NMS") is False
            assert library.use_kernel(meta, "NMS") is False
            if fail:
                raise RuntimeError("inside the switch")
    with pytest.raises(NotImplementedError):
        library.use_kernel(meta, "NMS")


def _roi_pool_call():
    feats = torch.randn(1, 2, 9, 9, generator=torch.Generator().manual_seed(0), requires_grad=True)
    return prp.roi_pool_batch(feats, torch.tensor([[[0.0, 1.0, 6.0, 8.0]]]), 1.0, 7), feats


def _align_call():
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(1, 2, s, s, generator=gen, requires_grad=True) for s in (16, 8, 4, 2)]
    return pra.multiscale_roi_align_batch(feats, torch.tensor([[[2.0, 3.0, 40.0, 50.0]]])), feats[0]


def _frozen_bn_call():
    x = torch.randn(1, 2, 4, 4, generator=torch.Generator().manual_seed(2), requires_grad=True)
    vec = torch.tensor([0.5, -0.5])
    return fbn.frozen_bn(x, vec, vec.abs(), vec, relu=True), x


# module, its forward and backward kernel wrappers with their plain twins,
# and a differentiable call through its autograd function
AUTOGRAD_SITES = {
    "roi_pool": (
        prp, ("roi_pool_cuda", "roi_pool_reference"),
        ("roi_pool_backward_cuda", "roi_pool_backward_reference"), _roi_pool_call,
    ),
    "multiscale_roi_align": (
        pra, ("multiscale_roi_align_cuda", "multiscale_roi_align_reference"),
        ("multiscale_roi_align_backward_cuda", "multiscale_roi_align_backward_reference"), _align_call,
    ),
    "frozen_bn": (
        fbn, ("frozen_bn_cuda", "frozen_bn_reference"),
        ("frozen_bn_backward_cuda", "frozen_bn_backward_reference"), _frozen_bn_call,
    ),
}


@pytest.mark.parametrize("site", list(AUTOGRAD_SITES))
def test_backward_takes_the_forward_path(site, monkeypatch):
    mod, fwd, bwd, call = AUTOGRAD_SITES[site]
    calls = []
    for kernel, twin in (fwd, bwd):
        plain = getattr(mod, twin)
        monkeypatch.setattr(
            mod, kernel, lambda *a, _k=kernel, _p=plain, **kw: calls.append(_k) or _p(*a, **kw)
        )
    monkeypatch.setattr(mod, "use_kernel", lambda t, what: True)
    out, leaf = call()
    monkeypatch.setattr(mod, "use_kernel", library.use_kernel)  # a CPU tensor: the plain version
    out.sum().backward()
    assert calls == [fwd[0], bwd[0]]
    assert leaf.grad is not None

"""The port imports nothing of JAX, flax or the JAX package.

An AST scan of every module of ``faster_rcnn_pytorch_tpu_torch/``, of
``chip_smoke.py`` and of ``examples/tutorial_torch.py``: any ``import`` or ``from ... import`` of ``jax``,
``flax`` or ``faster_rcnn_pytorch_tpu`` (not ``faster_rcnn_pytorch_tpu_torch``),
at any depth of the module (inside functions too), fails. The port keeps
its own copies of the JAX package's host modules (``config.py``,
``data/``, ``evaluation/coco_eval.py``) instead.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "faster_rcnn_pytorch_tpu")


def _port_files():
    files = ["chip_smoke.py", os.path.join("examples", "tutorial_torch.py")]
    for base, _, names in os.walk(os.path.join(REPO, "faster_rcnn_pytorch_tpu_torch")):
        files += [
            os.path.relpath(os.path.join(base, n), REPO) for n in sorted(names) if n.endswith(".py")
        ]
    return sorted(files)


def forbidden_imports(source: str) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_scan_finds_what_it_forbids():
    src = (
        "import jax\nimport flax.linen as nn\nfrom faster_rcnn_pytorch_tpu.config import x\n"
        "def f():\n    from jax import numpy\n"
        "import faster_rcnn_pytorch_tpu_torch.ops\nfrom . import sibling\nimport numpy\n"
    )
    assert forbidden_imports(src) == ["jax", "flax.linen", "faster_rcnn_pytorch_tpu.config", "jax"]


@pytest.mark.parametrize("path", _port_files())
def test_port_module_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        assert forbidden_imports(f.read()) == [], path

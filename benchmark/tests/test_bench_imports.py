"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under ``benchmark/`` (top-level names compared whole: the port's name
begins with the JAX package's), and nothing of the port in the
reference. And a checkout without the port gives no result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "faster_rcnn_pytorch_tpu"}
PORT = "faster_rcnn_pytorch_tpu_torch"


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.add(arg.value.split(".")[0])
    return out


def sources(sub: str = ""):
    root = os.path.join(manifest.BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_run_time_check_compares_whole_names(monkeypatch):
    from benchmark.lib import result

    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert result.forbidden_modules() == [] or PORT not in result.forbidden_modules()
    monkeypatch.setitem(sys.modules, "faster_rcnn_pytorch_tpu.fake", object())
    assert "faster_rcnn_pytorch_tpu" in result.forbidden_modules()


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_no_jax_anywhere(path):
    assert not (top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)
    assert PORT not in open(path).read()


def test_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "legacy_voc_train_b8", "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout

"""The port's ``data/visualize.py::draw_boxes_matplotlib`` against the
JAX package's, under matplotlib's Agg backend.

Seeded images (uint8, and float32 that the helper stretches to uint8),
boxes, labels, class names and scores go through both helpers, each
saving a PNG; the figures must hold the same image data, the same
rectangles (corner, width, height, edge colour, line width, unfilled) and
the same captions (position, text, colours). The module imports on a host
without matplotlib, where the helper is the only thing that needs it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from faster_rcnn_pytorch_tpu.data.visualize import draw_boxes_matplotlib as jax_draw  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.data.visualize import draw_boxes_matplotlib  # noqa: E402
from tests.torch_threads import subprocess_env  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = tuple(f"class{i}" for i in range(21))


def _inputs(seed: int, float_image: bool, n: int = 6):
    rs = np.random.RandomState(seed)
    h, w = 90, 120
    image = rs.normal(size=(h, w, 3)).astype(np.float32) if float_image else rs.randint(
        0, 255, (h, w, 3), dtype=np.uint8
    )
    xy = rs.uniform(0, 80, size=(n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 40, size=(n, 2))], 1)
    return image, boxes, rs.randint(0, 21, size=n), rs.uniform(0, 1, size=n)


def _drawn(fig):
    (ax,) = fig.axes
    rects = [
        (p.get_xy(), p.get_width(), p.get_height(), p.get_edgecolor(), p.get_linewidth(), p.get_fill())
        for p in ax.patches
    ]
    texts = [
        (t.get_position(), t.get_text(), t.get_color(), t.get_bbox_patch().get_facecolor())
        for t in ax.texts
    ]
    return np.asarray(ax.images[0].get_array()), rects, texts


@pytest.mark.parametrize("float_image", [False, True])
@pytest.mark.parametrize("captions", ["names_and_scores", "scores", "none"])
def test_draws_what_the_jax_helper_draws(float_image, captions, tmp_path):
    image, boxes, labels, scores = _inputs(3, float_image)
    kw = {
        "names_and_scores": dict(labels=labels, class_names=NAMES, scores=scores),
        "scores": dict(labels=labels, scores=scores),
        "none": {},
    }[captions]
    got_path, want_path = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    got = _drawn(draw_boxes_matplotlib(image, boxes, save_path=got_path, **kw))
    want = _drawn(jax_draw(image, boxes, save_path=want_path, **kw))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.uint8
    assert got[1] == want[1] and len(got[1]) == len(boxes)
    assert got[2] == want[2]
    assert len(got[2]) == (0 if captions == "none" else len(boxes))
    assert os.path.getsize(got_path) > 0 and os.path.getsize(want_path) > 0


def test_the_module_imports_without_matplotlib():
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import faster_rcnn_pytorch_tpu_torch.data.visualize as v\n"
        "try:\n    v.draw_boxes_matplotlib(None, [], save_path='x.png')\n"
        "except ImportError:\n    print('needs matplotlib')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "needs matplotlib"

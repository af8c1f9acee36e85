"""``evaluate``'s ``max_images`` and ``max_detections`` against the JAX
``evaluate``.

Both packages evaluate the same reference-layout weights (the JAX
``init_detector_params``, carried over by ``legacy_state_dict_from_jax``)
on the same 5-image VOC test split (``tests/test_preflight.py``'s tree)
at a 64-pixel resize, float32, small proposal budgets and a 0.01 score
threshold. The JAX ``evaluate`` dumps its detections (``dump_path``); the
port returns its own. They must have taken the same images, in the same
order, and agree under the greedy match of test_torch_legacy_predict
(label, IoU >= 0.99, 99% matched, score and box |d| <= 1e-4 canvas
units):

* ``max_images=2`` at batch 1 takes two images;
* ``max_images=1`` at batch 2 and ``max_images=3`` at batch 2 take the
  batch that reaches the limit whole (two and four images);
* ``max_detections=4`` keeps at most 4 detections an image.

Two ranks over gloo (``tests/torch_dist.py``), one image a rank of each
host batch of 2, stop at the same batch under ``max_images=3``: the
merged image ids and detections are one process's.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.data.loader import DetectionLoader as JaxLoader
from faster_rcnn_pytorch_tpu.data.transforms import EvalTransform as JaxEvalTransform
from faster_rcnn_pytorch_tpu.data.voc import load_voc_records as jax_voc_records
from faster_rcnn_pytorch_tpu.engine.evaluate import evaluate as jax_evaluate
from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu_torch.data.loader import DetectionLoader
from faster_rcnn_pytorch_tpu_torch.data.transforms import EvalTransform
from faster_rcnn_pytorch_tpu_torch.data.voc import load_voc_records
from faster_rcnn_pytorch_tpu_torch.engine.evaluate import evaluate
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils.convert import legacy_state_dict_from_jax
from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics
from tests import torch_dist_workers as w
from tests.test_preflight import _make_voc_tree
from tests.test_torch_legacy_predict import assert_detections_match
from tests.torch_dist import run_ranks

N_TEST = 5
SIZE, MAX_SIZE = 64, 96
THRES = 0.01
BUDGETS = dict(pre_nms_test=64, post_nms_test=16)
# 1e-4 canvas units in original pixels: the 96-px canvas holds the
# 85-px-wide resize of the 120-px images.
BOX_TOL_PX = 1e-4 * 96 * 120 / 85


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_limits")
    _make_voc_tree(root, n=N_TEST)
    jmodel, _ = jfr.build_model("legacy", num_classes=21, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(3), canvas=64))
    set_numerics("float32")
    pmodel, _ = pfr.build_model("legacy", num_classes=21)
    pmodel.load_state_dict(legacy_state_dict_from_jax(params), strict=True)
    return str(root), jmodel, params, pmodel.eval()


def _loaders(root: str, batch_size: int):
    kw = dict(batch_size=batch_size, size=SIZE, max_size=MAX_SIZE, shuffle=False,
              num_workers=0, drop_last=False)
    return (
        JaxLoader(jax_voc_records(root, "test"), JaxEvalTransform(size=SIZE, max_size=MAX_SIZE), **kw),
        DetectionLoader(load_voc_records(root, "test"), EvalTransform(size=SIZE, max_size=MAX_SIZE), **kw),
    )


def _both(setup, tmp_path, batch_size: int, **limits):
    """(the JAX evaluate's dumped detections, the port's result)."""
    root, jmodel, params, pmodel = setup
    jax_loader, port_loader = _loaders(root, batch_size)
    jcfg = dataclasses.replace(jfr.LEGACY_CONFIG, num_classes=21, **BUDGETS)
    pcfg = dataclasses.replace(pfr.LEGACY_CONFIG, num_classes=21, **BUDGETS)
    dump = str(tmp_path / "jax.pkl")
    jax_evaluate(jmodel, jcfg, params, jax_loader, data_type="voc", score_threshold=THRES,
                 dump_path=dump, **limits)
    with open(dump, "rb") as f:
        want = pickle.load(f)
    got = evaluate(pmodel, pcfg, port_loader, data_type="voc", score_threshold=THRES,
                   verbose=False, **limits)
    return want, got


@pytest.mark.parametrize("batch_size,max_images,taken", [(1, 2, 2), (2, 1, 2), (2, 3, 4)])
def test_max_images_takes_the_jax_evaluates_images(setup, tmp_path, batch_size, max_images, taken):
    want, got = _both(setup, tmp_path, batch_size, max_images=max_images)
    ids = list(got["detections"])
    assert ids == list(want["predictions"]) == list(range(taken))
    assert got["n_images"] == taken
    assert sorted(want["gts"]) == ids  # ground truths of the images taken only
    for i in ids:
        assert_detections_match(got["detections"][i], want["predictions"][i], box_tol=BOX_TOL_PX)
    assert sum(len(d["scores"]) for d in got["detections"].values()) > 0


def test_max_detections_is_the_jax_evaluates_budget(setup, tmp_path):
    want, got = _both(setup, tmp_path, 1, max_detections=4)
    assert list(got["detections"]) == list(want["predictions"]) == list(range(N_TEST))
    for i, d in got["detections"].items():
        assert len(d["scores"]) == len(want["predictions"][i]["scores"]) == 4
        assert_detections_match(d, want["predictions"][i], box_tol=BOX_TOL_PX)


def test_two_ranks_stop_at_the_same_batch(tmp_path):
    spec = dict(data_type="voc", n_images=5, batch_size=2, max_images=3)
    two = run_ranks(w.jobs, 2, tmp_path / "ranks", [("eval_job", spec)], timeout=600)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: the CPU products' order follows the threads
    try:
        one = w.eval_job(0, **spec)
    finally:
        torch.set_num_threads(threads)
    assert list(one["detections"]) == [0, 1, 2, 3] and one["n_images"] == 4
    for (got,) in two:
        assert got["n_images"] == 4
        assert sorted(got["detections"]) == [0, 1, 2, 3]
        for i, d in one["detections"].items():
            for k in ("boxes", "labels", "scores"):
                np.testing.assert_array_equal(got["detections"][i][k], d[k], err_msg=f"{i} {k}")

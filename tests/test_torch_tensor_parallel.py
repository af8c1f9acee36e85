"""The port's tensor parallelism (Megatron fc6/fc7) on the CPU.

* The split follows the JAX package's ``_tp_spec``: fc6 by its outputs
  (the JAX kernel's dim 1, the torch weight's rows, and the bias), fc7 by
  its inputs (the JAX kernel's dim 0, the torch weight's columns; its
  bias whole); shard ``r`` holds the JAX kernel's slice ``r``. Both
  generations, no process group needed.
* Four ranks (data 2 x model 2, ``tests/torch_dist.py``) run two legacy
  steps on the two-image batch of ``tests/torch_dist_workers.py``: the
  losses within 1e-5 relative of the one-process step's, the first step's
  gradients and the parameters after two steps within ``1e-5 *
  max|g|`` (``max|p|``), gathered to the single-device layout.
* Replicas stay bit-identical: every replicated parameter on all four
  ranks (reduced over all of them), every fc6/fc7 shard on the two data
  ranks that hold it.
* ``gather_state_dict`` gives a state dict that loads ``strict=True``
  into a one-process model; each rank holds half of fc6's rows and of
  fc7's columns.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu.parallel.mesh import MODEL_AXIS, _tp_spec
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import (
    apply_tensor_parallel,
    shard_state_dict,
)
from faster_rcnn_pytorch_tpu_torch.utils.convert import (
    fpn_state_dict_from_jax,
    legacy_state_dict_from_jax,
)
from tests import torch_dist_workers as w
from tests.test_torch_distributed_step import _assert_close, _assert_metrics
from tests.torch_dist import run_ranks

JAX_NAMES = {"classifier.0.weight": "fc6/kernel", "classifier.0.bias": "fc6/bias",
             "classifier.2.weight": "fc7/kernel", "classifier.2.bias": "fc7/bias"}


@pytest.mark.parametrize("generation", ["legacy", "fpn"])
def test_shards_follow_the_jax_tp_spec(generation):
    jmodel, _ = jfr.build_model(generation, num_classes=w.NUM_CLASSES, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(0), canvas=64))
    specs = {
        "/".join(str(getattr(q, "key", q)) for q in path): spec
        for path, spec in jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map_with_path(lambda p, x: _tp_spec(p, x, 2), params),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec),
        )[0]
    }
    convert = legacy_state_dict_from_jax if generation == "legacy" else fpn_state_dict_from_jax
    full = convert(params)
    jflat = {
        "/".join(str(getattr(q, "key", q)) for q in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    for rank in range(2):
        model, _ = pfr.build_model(generation, w.NUM_CLASSES)
        apply_tensor_parallel(model, None, rank, 2)
        model.load_state_dict(shard_state_dict(model, full, rank, 2), strict=True)
        assert model.classifier is getattr(model, "fast_rcnn_head" if generation == "legacy"
                                           else "frcnn_head").classifier
        for name, jname in JAX_NAMES.items():
            key = next(k for k in specs if k.endswith(jname))
            spec = tuple(specs[key])
            local = model.state_dict()[name].numpy()
            kernel = jflat[key]
            if jname == "fc7/bias":
                assert spec == ()
                np.testing.assert_array_equal(local, kernel)
                continue
            dim = spec.index(MODEL_AXIS)  # the JAX layout's split dim
            want = np.split(kernel, 2, axis=dim)[rank]
            if name == "classifier.0.weight":
                # fc6's inputs are permuted from (7, 7, C) to (C, 7, 7) by the
                # export; its outputs, the split dim, are not
                np.testing.assert_array_equal(np.sort(local, 1), np.sort(want.T, 1))
                np.testing.assert_array_equal(local, np.split(full[name].numpy(), 2, 0)[rank])
                continue
            if kernel.ndim == 2:
                want = want.T  # JAX [in, out] -> torch [out, in]
            np.testing.assert_array_equal(local, want, err_msg=name)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    ref = str(tmp / "reference.pt")
    run = w.train_steps(0, "legacy", 2, 2)
    torch.save({"grads": run.pop("grads"), "params": run.pop("params")}, ref)
    specs = [
        ("train_steps", dict(generation="legacy", global_b=2, steps=2, reference=ref)),
        ("tp_layout", {}),
    ]
    out = run_ranks(w.jobs, 4, tmp / "ranks", specs, model_parallel=2, timeout=600)
    yield run, out
    shutil.rmtree(tmp, ignore_errors=True)


def test_data2_model2_step_matches_one_process(four_ranks):
    want, out = four_ranks
    got = out[0][0]
    _assert_metrics(got["metrics"], want["metrics"])
    _assert_close(got["grads"], "first step's gradients")
    _assert_close(got["params"], "parameters after the steps")


def test_replicas_are_bit_identical(four_ranks):
    _, out = four_ranks
    digests = [r[0]["digests"] for r in out]
    split = {k for k in digests[0] if k.startswith("classifier.") and k != "classifier.2.bias"}
    for k in digests[0]:
        if k in split:  # data ranks 0 and 1 of one model rank
            assert digests[0][k] == digests[2][k] and digests[1][k] == digests[3][k], k
            assert digests[0][k] != digests[1][k], k
        else:
            assert len({d[k] for d in digests}) == 1, k


def test_layout_shards_and_gathered_state_loads_strictly(four_ranks):
    _, out = four_ranks
    layouts = [r[1]["layout"] for r in out]
    assert layouts == [(0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]
    for r in out:
        assert r[1]["loads_strict"]
        assert r[1]["shapes"] == {
            "classifier.0.weight": (2048, 25088), "classifier.0.bias": (2048,),
            "classifier.2.weight": (4096, 2048), "classifier.2.bias": (4096,),
        }

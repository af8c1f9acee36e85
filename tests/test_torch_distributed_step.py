"""The port's data-parallel train step (DDP over gloo) on the CPU.

Two ranks (``tests/torch_dist.py``) each take one row of a two-image
global batch whose second image has a small extent, so the two ranks'
loss counts differ (56 and 3 trainable anchors): a per-rank mean would
not be the global mean there. Against the port's one-process step on the
same global batch (``tests/torch_dist_workers.py``):

* legacy and FPN (its convolutions batch-invariant on both sides, see
  ``train_steps``): losses within 1e-5 relative, the first step's
  gradients and the parameters after two steps within ``1e-5 * max|g|``
  (``max|p|`` for the parameters) per tensor; every parameter bit-identical
  on the two ranks after the steps (the FPN's frozen stem and ``layer1``,
  left out of DDP's reducer, decayed identically too);
* ``--grad_accum 2`` over a four-image global batch (two a rank) equals
  the one-process step with ``grad_accum=2``;
* the logged metrics are the global batch's: losses within 1e-5
  relative (from the second step on, when the parameters already differ
  by rounding, each term within 1e-5 of the total), positive counts
  equal.

Against the JAX package: the same two-rank legacy step from the JAX
package's weights, fed its sampling noise, against JAX's ``forward_train``
gradient on the one-device global batch (which JAX's own
``test_dp_train_step_and_parity`` holds equal to its SPMD step on a
mesh; compiling the two-device mesh step here would double the file's
time), within ``tests/test_torch_train_step.py``'s tolerances.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
from faster_rcnn_pytorch_tpu_torch.utils.convert import legacy_state_dict_from_jax
from tests import torch_dist_workers as w
from tests.test_torch_train_step import _UNDER_A_POOL, jax_noise
from tests.torch_dist import run_ranks

JOBS = {
    "legacy": ("train_steps", dict(generation="legacy", global_b=2, steps=2, record_counts=True)),
    "fpn": ("train_steps", dict(generation="fpn", global_b=2, steps=2, batch_invariant=True)),
    "accum": ("train_steps", dict(generation="legacy", global_b=4, steps=1, accum=2)),
}


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    """The module's files (weights and references of 0.3-1.1 GB each),
    removed when its tests are done."""
    path = tmp_path_factory.mktemp("distributed_step")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_reference(tmp_dir):
    """JAX weights (exported to the port's layout) and noise, and a file of
    the JAX gradients of one legacy ``forward_train`` on the global batch;
    its losses."""
    path = str(tmp_dir / "jax_weights.pt")
    cfg = dataclasses.replace(
        jfr.LEGACY_CONFIG, **{f: getattr(w.LEGACY, f) for f in (
            "num_classes", "pre_nms_train", "post_nms_train", "roi_samples", "roi_pos_quota")}
    )
    jmodel, _ = jfr.build_model("legacy", num_classes=w.NUM_CLASSES, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jfr.init_detector_params(jmodel, jax.random.key(0), canvas=64))
    torch.save(legacy_state_dict_from_jax(params), path)
    batch = w.make_batch(2)
    rng = jax.random.key(1)
    n_anchors = w.new_model("legacy").canvas_anchors(*w.CANVAS).shape[0]
    noise = jax_noise(rng, 2, n_anchors, cfg.post_nms_train + batch["gt_boxes"].shape[1])
    args = [jnp.asarray(batch[k]) for k in w.KEYS]

    def loss_fn(p):
        out = jmodel.apply(p, cfg, *args, rng, method=jfr.forward_train)
        return out.losses.total, out.losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = str(tmp_dir / "jax_grads.pt")
    torch.save({"grads": legacy_state_dict_from_jax(jax.tree.map(np.asarray, grads))}, ref)
    return path, noise, losses, ref


@pytest.fixture(scope="module")
def one_rank(tmp_dir):
    """The one-process runs' metrics; their gradients and parameters go to
    a reference file per job, which rank 0 reads."""
    out = {}
    for name, (fn, kw) in JOBS.items():
        run = getattr(w, fn)(0, **kw)
        out[name] = str(tmp_dir / f"reference_{name}.pt")
        torch.save({"grads": run.pop("grads"), "params": run.pop("params")}, out[name])
        out[name] = (run, out[name])
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_dir, jax_reference, one_rank):
    path, noise, _, jax_grads = jax_reference
    specs = [(fn, {**kw, "reference": one_rank[name][1]}) for name, (fn, kw) in JOBS.items()]
    specs.append(
        ("train_steps", dict(generation="legacy", global_b=2, steps=1, noise=noise, weights=path,
                             reference=jax_grads))
    )
    out = run_ranks(w.jobs, 2, tmp_dir / "ranks", specs, timeout=600)
    return {name: [r[i] for r in out] for i, name in enumerate([*JOBS, "jax"])}


def _assert_close(errs: dict, what: str):
    assert errs
    for k, (err, scale, _, _) in errs.items():
        assert err <= 1e-5 * max(scale, 1e-30), (what, k, err, scale)


def _assert_metrics(got: list, want: list):
    assert len(got) == len(want)
    for step, (g, m) in enumerate(zip(got, want)):
        assert g.keys() == m.keys()
        for k, v in m.items():
            if k.startswith("num_pos"):
                assert g[k] == v, (step, k, g[k], v)
            else:
                # after the first step the parameters differ by rounding
                # (<= 1e-5 max|p|): each term within 1e-5 of the total
                scale = abs(v) if step == 0 or k == "loss" else abs(m["loss"])
                assert abs(g[k] - v) <= 1e-5 * scale, (step, k, g[k], v)


@pytest.mark.parametrize("name", ["legacy", "fpn", "accum"])
def test_two_ranks_match_one_process(two_ranks, one_rank, name):
    got, want = two_ranks[name][0], one_rank[name][0]
    _assert_metrics(got["metrics"], want["metrics"])
    _assert_close(got["grads"], "first step's gradients")
    _assert_close(got["params"], "parameters after the steps")


@pytest.mark.parametrize("name", ["legacy", "fpn", "accum", "jax"])
def test_replicas_stay_bit_identical(two_ranks, name):
    a, b = (r["digests"] for r in two_ranks[name])
    assert a.keys() == b.keys()
    assert [k for k in a if a[k] != b[k]] == []


def test_per_rank_counts_differ_and_the_loss_is_global(two_ranks, one_rank):
    """Trap A would show here: the ranks' trainable-anchor counts differ."""
    (c0, c1) = (r["counts"][0] for r in two_ranks["legacy"])
    assert c0[0] != c1[0] and c0[0] > 0 and c1[0] > 0, (c0, c1)
    _assert_metrics(two_ranks["legacy"][0]["metrics"], one_rank["legacy"][0]["metrics"])


def test_fpn_frozen_stages_decay_alike(two_ranks, one_rank):
    """Left out of DDP's reducer, the frozen stem and ``layer1`` decay as
    one process decays them: bit for bit, and away from their init."""
    errs = two_ranks["fpn"][0]["params"]
    want = torch.load(one_rank["fpn"][1], weights_only=True, mmap=True)["params"]
    model = w.new_model("fpn")
    frozen = [k for k, _ in model.named_parameters() if k.startswith(model.frozen_prefixes)]
    assert frozen
    init = model.state_dict()
    for k in frozen:
        assert errs[k][0] == 0.0, k
        assert not torch.equal(want[k], init[k]), k  # weight decay moved them


def test_two_rank_step_matches_jax(two_ranks, jax_reference):
    _, _, losses, _ = jax_reference
    got = two_ranks["jax"][0]
    metrics = got["metrics"][0]
    for name in ("rpn_cls", "rpn_reg", "roi_cls", "roi_reg"):
        v = float(getattr(losses, name))
        assert abs(metrics[name] - v) <= 1e-5 * abs(v), (name, metrics[name], v)
    assert got["grads"]
    for name, (err, scale, l2, ref_l2) in got["grads"].items():
        assert scale > 0, name
        if name.rsplit(".", 1)[0] in _UNDER_A_POOL:
            assert l2 <= 2e-3 * ref_l2, (name, l2 / ref_l2)
        else:
            assert err <= 1e-4 * scale, (name, err / scale)

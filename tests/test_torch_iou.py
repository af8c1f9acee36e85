"""The port's pairwise IoU (``ops/boxes.py``) against the JAX package.

* ``pairwise_iou_reference``, the CUDA kernel's plain twin, against
  ``pairwise_iou_pallas(..., interpret=True)`` at eps 1e-5 and eps 0, on
  sets with degenerate, coincident and zero (padded) boxes: within 1e-6
  (the jitted JAX function is compiled by XLA, which on the CPU contracts
  some of the union's products and sums into FMAs; measured: 3 of 60,000
  elements differ, by at most 1.79e-7, 3.1e-7 relative).
* ``masked_iou``'s gate: a 2-D problem of at least 2**20 pairs goes
  through ``pairwise_iou`` (on the CPU its twin), a smaller one through
  ``jaccard_iou``, at exactly the sizes where the JAX package switches to
  its Pallas kernel: ``frcnn_targets``' (post_nms_train + G) x G passes it
  at G = 432, not 431, for legacy and at 640, not 639, for FPN. At the
  legacy ``--max_gt 512`` size the port equals JAX's ``masked_iou`` (run
  op by op on the CPU: its ``jaccard_iou``) bit for bit.
* ``--max_gt 512`` reaches the train batch: the port's loader pads (and
  truncates: 600 objects in one image) the gt to 512 slots exactly as the
  JAX package's loader does.
* The CUDA wrapper refuses CPU tensors; on a card only (skipped here) the
  kernel equals its twin bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from faster_rcnn_pytorch_tpu import config as jax_config
from faster_rcnn_pytorch_tpu.data import loader as jax_loader
from faster_rcnn_pytorch_tpu.ops import boxes as jb
from faster_rcnn_pytorch_tpu.ops.pallas.iou_kernel import pairwise_iou_pallas
from faster_rcnn_pytorch_tpu_torch import config as port_config
from faster_rcnn_pytorch_tpu_torch.data import loader as port_loader
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import FPN_CONFIG, LEGACY_CONFIG
from faster_rcnn_pytorch_tpu_torch.ops import boxes as pb
from tests.conftest import boxes_fixture


def _sets(rs, n, m):
    a = boxes_fixture(rs, n)
    b = boxes_fixture(rs, m)
    a[:3] = [0.5, 0.5, 0.5, 0.5]  # coincident zero-area boxes: the union floor
    b[:2] = [0.5, 0.5, 0.5, 0.5]
    a[3:6, 2] = a[3:6, 0]  # zero width
    a[6:10] = b[10:14]  # coincident with some of b
    b[-20:] = 0.0  # padded gt slots
    a[-5:] = 0.0
    return a, b


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_plain_matches_jax_pallas_kernel(eps):
    a, b = _sets(np.random.RandomState(3), 300, 200)
    want = np.asarray(
        pairwise_iou_pallas(jnp.asarray(a), jnp.asarray(b), eps=eps, block_n=64, block_m=128, interpret=True)
    )
    got = pb.pairwise_iou_reference(torch.tensor(a), torch.tensor(b), eps)
    assert got.dtype == torch.float32 and got.shape == (300, 200)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.isfinite(want).all() and (want[:3, :2] == 0).all()  # 0 / 1e-12 at eps 0


def _gt(rs, slots, real):
    gt = np.zeros((slots, 4), np.float32)
    gt[:real] = boxes_fixture(rs, real, scale=0.9)
    mask = np.zeros(slots, bool)
    mask[:real] = True
    return gt, mask


def _spy(monkeypatch):
    calls = []
    plain = pb.pairwise_iou_reference

    def spy(a, b, eps=1e-5, col_mask=None):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return plain(a, b, eps, col_mask)

    monkeypatch.setattr(pb, "pairwise_iou_reference", spy)
    return calls


def test_masked_iou_above_the_gate_matches_jax(monkeypatch):
    rs = np.random.RandomState(4)
    gt, mask = _gt(rs, 512, 400)
    cand = np.concatenate([boxes_fixture(rs, LEGACY_CONFIG.post_nms_train), gt])
    cand[:400] = np.clip(gt[:400] + rs.normal(0, 0.01, (400, 4)), 0, 1).astype(np.float32)
    calls = _spy(monkeypatch)
    before = pb.pairwise_iou_cuda.launches
    got = pb.masked_iou(torch.tensor(cand), torch.tensor(gt), torch.tensor(mask))
    assert calls == [((2512, 4), (512, 4))] and pb.pairwise_iou_cuda.launches == before
    want = np.asarray(jb.masked_iou(jnp.asarray(cand), jnp.asarray(gt), jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 400:] == -1).all() and float(got.max()) > 0.5


@pytest.mark.parametrize(
    "post_nms,slots,inside",
    [
        (LEGACY_CONFIG.post_nms_train, 432, True),
        (LEGACY_CONFIG.post_nms_train, 431, False),
        (FPN_CONFIG.post_nms_train, 640, True),
        (FPN_CONFIG.post_nms_train, 639, False),
    ],
)
def test_gate_boundaries_are_the_jax_packages(monkeypatch, post_nms, slots, inside):
    rs = np.random.RandomState(slots)
    gt, mask = _gt(rs, slots, 50)
    cand = torch.tensor(np.concatenate([boxes_fixture(rs, post_nms), gt]))
    assert ((post_nms + slots) * slots >= 1 << 20) == inside  # the JAX gate, by hand
    calls = _spy(monkeypatch)
    got = pb.masked_iou(cand, torch.tensor(gt), torch.tensor(mask))
    assert len(calls) == int(inside)
    want = torch.where(torch.tensor(mask)[None], pb.jaccard_iou(cand, torch.tensor(gt)), -1.0)
    assert torch.equal(got, want)  # the twin is jaccard_iou on float32 inputs


def test_batched_problems_and_cuda_wrapper(monkeypatch):
    rs = np.random.RandomState(5)
    gt, mask = _gt(rs, 512, 30)
    cand = torch.tensor(np.stack([np.concatenate([boxes_fixture(rs, 2000), gt])] * 2))
    calls = _spy(monkeypatch)
    pb.masked_iou(cand, torch.tensor(np.stack([gt] * 2)), torch.tensor(np.stack([mask] * 2)))
    assert calls == []  # only a 2-D problem goes to the kernel, as in JAX
    with pytest.raises(ValueError, match="CUDA"):
        pb.pairwise_iou_cuda(cand[0], torch.tensor(gt))  # no silent CPU path
    with pytest.raises(NotImplementedError):
        pb.pairwise_iou(cand[0].to("meta"), torch.tensor(gt).to("meta"))


def _dense_voc(root, n_objects=600):
    """A VOC tree whose train images hold ``n_objects`` small boxes each."""
    rs = np.random.RandomState(8)
    for split in ("VOCtrainval_2007", "VOCtest_2007"):
        base = root / split / "VOCdevkit" / "VOC2007"
        (base / "Annotations").mkdir(parents=True)
        (base / "JPEGImages").mkdir(parents=True)
        for i in range(2):
            xy = rs.randint(1, 280, size=(n_objects, 2))
            objects = "".join(
                f"<object><name>bottle</name><difficult>0</difficult><bndbox><xmin>{x}</xmin>"
                f"<ymin>{y}</ymin><xmax>{x + 15}</xmax><ymax>{y + 12}</ymax></bndbox></object>"
                for x, y in xy
            )
            (base / "Annotations" / f"im{i:03d}.xml").write_text(
                f"<annotation><size><width>300</width><height>300</height><depth>3</depth></size>"
                f"{objects}</annotation>"
            )
            Image.fromarray(rs.randint(0, 255, (300, 300, 3), dtype=np.uint8)).save(
                base / "JPEGImages" / f"im{i:03d}.jpg"
            )
    return str(root)


def test_max_gt_reaches_the_train_batch_as_in_jax(tmp_path):
    root = _dense_voc(tmp_path)
    argv = ["--data_root", root, "--max_gt", "512", "--resize", "128", "--max_size", "192",
            "--batch_size", "2", "--num_workers", "0"]
    got = next(iter(port_loader.build_dataloader(port_config.load_options(argv))[0].epoch(0)))
    want = next(iter(jax_loader.build_dataloader(jax_config.load_options(argv))[0].epoch(0)))
    assert got["gt_boxes"].shape == (2, 512, 4)
    assert got["gt_mask"].sum() > 2 * 500  # truncated at 512, less what the crop dropped
    for key in ("gt_boxes", "gt_labels", "gt_mask", "extent"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_cuda_kernel_matches_plain_bit_for_bit(eps):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    a, b = _sets(np.random.RandomState(6), 2512, 512)
    ta, tb = torch.tensor(a).cuda(), torch.tensor(b).cuda()
    before = pb.pairwise_iou_cuda.launches
    got = pb.pairwise_iou(ta, tb, eps)
    torch.cuda.synchronize()
    assert pb.pairwise_iou_cuda.launches == before + 1
    assert torch.equal(got, pb.pairwise_iou_reference(ta, tb, eps))

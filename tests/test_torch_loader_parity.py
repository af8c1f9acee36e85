"""The port's train loader against the JAX package's, batch for batch.

Both packages' ``build_dataloader`` on one small VOC tree (8 train images,
landscape and portrait in turn, ``tests.test_data.VOC_XML``; 2 test
images) with ``--seed 7 --resize 192 --max_size 256 --batch_size 2``, as
``main`` builds them. The port's ``data/`` is a copy of the JAX package's;
only ``loader.py`` differs, by the data ranks' rows. The first two batches
of epochs 0 and 1 (the shuffle and the augmentation are seeded by
``--seed`` and the epoch) must be bit-equal in every key: images,
extents, gt boxes, labels and masks, dtype included. The port's loader is
read inline and through two worker processes: its stream does not depend
on the workers.

``loader_batches`` is also the input of ``tests/test_torch_train_trajectory.py``
and ``tests/test_torch_bf16_train_step.py``.
"""

import numpy as np
import pytest
from PIL import Image

from faster_rcnn_pytorch_tpu.config import load_options as jax_load_options
from faster_rcnn_pytorch_tpu.data.loader import build_dataloader as jax_build_dataloader
from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.data.loader import build_dataloader
from tests.test_data import VOC_XML

KEYS = ("image", "extent", "gt_boxes", "gt_labels", "gt_mask")
SEED = 7
FLAGS = ("--resize", "192", "--max_size", "256", "--batch_size", "2", "--seed", str(SEED))
EPOCHS, BATCHES = (0, 1), 2


def make_voc_tree(root) -> str:
    """8 train and 2 test images under ``root``, each with ``VOC_XML``'s
    two boxes (one ``difficult``)."""
    rs = np.random.RandomState(0)
    for split, n in (("VOCtrainval_2007", 8), ("VOCtest_2007", 2)):
        base = root / split / "VOCdevkit" / "VOC2007"
        (base / "Annotations").mkdir(parents=True)
        (base / "JPEGImages").mkdir(parents=True)
        for i in range(n):
            (base / "Annotations" / f"im{i:03d}.xml").write_text(VOC_XML)
            h, w = (90, 120) if i % 2 == 0 else (120, 90)
            img = rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
            img[20:70, 10:60] = [220, 40, 40]
            Image.fromarray(img).save(base / "JPEGImages" / f"im{i:03d}.jpg")
    return str(root)


def _batches(loader) -> list[dict]:
    out = []
    for epoch in EPOCHS:
        for i, batch in enumerate(loader.epoch(epoch)):
            if i == BATCHES:
                break
            out.append({k: np.array(batch[k]) for k in KEYS})
    return out


def loader_batches(root: str, package: str = "port", num_workers: int = 0) -> list[dict]:
    """The first ``BATCHES`` train batches of epochs 0 and 1 of
    ``package``'s (``port`` or ``jax``) loader on the tree at ``root``."""
    argv = ["--data_root", root, *FLAGS, "--num_workers", str(num_workers)]
    if package == "jax":
        train, _ = jax_build_dataloader(jax_load_options(argv))
    else:
        train, _ = build_dataloader(load_options(argv))
    return _batches(train)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    return make_voc_tree(tmp_path_factory.mktemp("voc_loader_parity"))


@pytest.fixture(scope="module")
def jax_batches(voc_tree):
    return loader_batches(voc_tree, "jax")


@pytest.mark.parametrize("num_workers", [0, 2])
def test_the_ports_batches_are_the_jax_packages(voc_tree, jax_batches, num_workers):
    got = loader_batches(voc_tree, "port", num_workers)
    assert len(got) == len(jax_batches) == len(EPOCHS) * BATCHES
    for i, (g, w) in enumerate(zip(got, jax_batches)):
        for k in KEYS:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (i, k)
            assert np.array_equal(g[k], w[k]), (i, k)
    # the stream moves: the epochs shuffle and augment differently
    assert not np.array_equal(jax_batches[0]["image"], jax_batches[BATCHES]["image"])
    assert any(w["gt_mask"].sum() > 0 for w in jax_batches)

"""MultiScaleRoIAlign at the samples' validity edge, against the JAX package.

A sample adds its bilinear value when ``-1 <= y <= height`` (and likewise
in x) and nothing outside, so the align is discontinuous in the roi where
a sample crosses ``-1`` or ``height``/``width``. These P2 rois put samples
exactly on those edges (a 112 x 28 pixel roi spans 28 x 7 cells at stride
4; its samples sit 2 cells apart, the first one cell in), plus the same
rois one float32 ulp inwards and outwards in the edge coordinate, and
degenerate rois whose extent floors to one cell at the edges. The port's
forward (``multiscale_roi_align_batch`` on the CPU: the plain version) and
its backward (the autograd function: the plain backward) are held against
the JAX package's ``multiscale_roi_align_batch`` and its VJP within
``1e-5 * max|ref|`` per level, as the other align tests hold them: both
sides pick the same samples on either side of every edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from faster_rcnn_pytorch_tpu.ops.roi_align import multiscale_roi_align_batch as jax_align
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra

STRIDES = (4, 8, 16, 32)
CANVAS = (256, 320)  # P2 64 x 80
C = 8


def _edge_rois():
    """P2 rois (canvas pixels) with samples on y = -1, y = 64, x = -1, x = 80."""
    h2, w2 = CANVAS[0] // 4, CANVAS[1] // 4
    long, short = 112.0, 28.0  # 28 and 7 cells: sqrt(area) = 56, level P2
    # first sample at start + 1 cell, last at start + 27 cells
    top, bottom = -4.0 * 2, 4.0 * (h2 - 27)
    left, right = -4.0 * 2, 4.0 * (w2 - 27)
    exact = [
        [20.0, top, 20.0 + short, top + long],
        [20.0, bottom, 20.0 + short, bottom + long],
        [left, 20.0, left + long, 20.0 + short],
        [right, 20.0, right + long, 20.0 + short],
    ]
    rois = []
    for r, axis in zip(exact, (1, 1, 0, 0)):
        for step in (0.0, -np.inf, np.inf):  # on the edge, one ulp either way
            moved = np.array(r, np.float32)
            if step:
                moved[axis] = np.nextafter(moved[axis], np.float32(step))
                moved[axis + 2] = np.nextafter(moved[axis + 2], np.float32(step))
            rois.append(moved)
    # extent floored to one cell (aligned=False), next to each edge
    rois += [
        np.array(r, np.float32)
        for r in ([30, -4.5, 30.5, -4.2], [30, 4 * h2 - 0.3, 30.5, 4 * h2], [-4.5, 30, -4.2, 30.5],
                  [4 * w2 - 0.3, 30, 4 * w2, 30.5])
    ]
    return np.stack(rois)[None]


def test_edge_samples_land_on_the_edges():
    rois = _edge_rois()[0][[0, 3, 6, 9]]
    s = np.float32(0.25)
    start = np.stack([rois[0, 1], rois[1, 1], rois[2, 0], rois[3, 0]]) * s
    extent = np.stack([rois[0, 3], rois[1, 3], rois[2, 2], rois[3, 2]]) * s - start
    bin_size = extent / np.float32(7)
    first = start + np.float32(0.5) * bin_size / np.float32(2)
    last = start + np.float32(6) * bin_size + np.float32(1.5) * bin_size / np.float32(2)
    np.testing.assert_array_equal(first[[0, 2]], [-1.0, -1.0])
    np.testing.assert_array_equal(last[[1, 3]], [CANVAS[0] / 4, CANVAS[1] / 4])
    level = pra.fpn_level_assignment(torch.tensor(_edge_rois()))
    assert (level == 0).all()


def test_forward_and_backward_match_jax_at_the_validity_edge():
    rs = np.random.RandomState(3)
    h, w = CANVAS
    feats = [rs.normal(size=(1, h // s, w // s, C)).astype(np.float32) for s in STRIDES]
    rois = _edge_rois()
    g = rs.normal(size=(*rois.shape[:2], 7, 7, C)).astype(np.float32)

    want, vjp = jax.vjp(
        lambda f: jax_align(f, jnp.asarray(rois), strides=STRIDES), tuple(jnp.asarray(f) for f in feats)
    )
    want_grads = vjp(jnp.asarray(g))[0]

    leaves = [torch.tensor(f).permute(0, 3, 1, 2).contiguous().requires_grad_(True) for f in feats]
    got = pra.multiscale_roi_align_batch(leaves, torch.tensor(rois))
    got.backward(torch.tensor(g).permute(0, 1, 4, 2, 3))

    want = np.asarray(want)
    err = np.abs(got.detach().permute(0, 1, 3, 4, 2).numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    assert np.abs(want).max() > 0
    for leaf, w_grad in zip(leaves, want_grads):
        w_grad = np.asarray(w_grad)
        err = np.abs(leaf.grad.permute(0, 2, 3, 1).numpy() - w_grad).max()
        assert err <= 1e-5 * max(np.abs(w_grad).max(), 1e-30), (err, np.abs(w_grad).max())
    assert np.abs(np.asarray(want_grads[0])).max() > 0  # every roi is on P2

"""Each roi's footprint, as ``chip_smoke.align_footprint_shape`` counts it.

The backward kernel (``ops/cuda/roi_align.cu``) lists each roi's footprint
in shared memory: the distinct rows and columns that its 14 samples' two
cells of nonzero weight touch on each axis, at most 28 each (its arrays
hold 28), and adds one sum per footprint cell and channel. Held on the
CPU, at the FPN canvas of ``chip_smoke.py``:

* on ``chip_smoke.footprint_rois`` (giant rois on P5, rois partly and
  wholly outside, degenerate rois, banners, 64 rois sharing one cell) and
  ``_align_rois``: at most 28 rows and 28 columns, with and without the
  zero-weight cells; the banner and the pole reach 28, degenerate rois
  at most 3;
* the footprint of nonzero weight holds exactly the cells that
  ``backward_scatter_terms`` gives a nonzero weight, roi by roi: the
  kernel's adds miss no term.
"""

import pytest
import torch

import chip_smoke
from faster_rcnn_pytorch_tpu_torch.ops import roi_align as pra

SHAPES = chip_smoke._align_level_shapes()


def _rois():
    g = torch.Generator().manual_seed(3)
    return torch.cat([chip_smoke.footprint_rois(g, 120), chip_smoke._align_rois(g, 200)], 1)


@pytest.mark.parametrize("nonzero", [False, True], ids=["all_corners", "nonzero_weight"])
def test_footprints_fit_the_kernel_lists(nonzero):
    rois = _rois()
    level = pra.fpn_level_assignment(rois)
    shape = chip_smoke.align_footprint_shape(rois, level, SHAPES, nonzero=nonzero)
    assert shape.shape == (*rois.shape[:2], 2)
    assert bool((shape <= 28).all())
    assert int(shape[:, :16].max()) == 28  # the banner and the pole reach the limit
    assert bool((level[:, :3] == 3).all())  # the giants go to P5
    # degenerate rois: a point's one-cell extent touches at most 3 cells an
    # axis, a zero-width line at most 2 columns
    assert bool((shape[:, 9:13] <= 3).all()) and bool((shape[:, 13, 1] <= 2).all())
    # wholly outside: the corners clamp onto cells, but none has a nonzero weight
    outside = shape[:, [3, 7, 8]].prod(-1)
    assert bool((outside == 0).all()) if nonzero else bool((outside > 0).all())


def test_backward_footprint_holds_every_nonzero_term():
    rois = _rois()[:1]
    level = pra.fpn_level_assignment(rois)
    shape = chip_smoke.align_footprint_shape(rois, level, SHAPES, nonzero=True)[0]
    image = torch.zeros(1, dtype=torch.int64)
    grad = torch.ones(1, 1, 7, 7)
    for i in range(rois.shape[1]):
        li = int(level[0, i])
        h, w = SHAPES[li]
        rows, vals = pra.backward_scatter_terms(grad, rois[0, i : i + 1], image, pra.STRIDES[li], h, w)
        cells = torch.unique(rows[vals[:, 0] != 0])
        assert len(cells) == int(shape[i].prod()), (i, rois[0, i].tolist())
        if len(cells):  # else an axis has no cell of nonzero weight: nothing to add
            assert len(torch.unique(cells // w)) == int(shape[i, 0])
            assert len(torch.unique(cells % w)) == int(shape[i, 1])

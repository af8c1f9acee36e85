"""Work item ``roi_align_bwd``: the kernels it launches and the least work a call
needs."""

from benchmark.roofline.work import nbytes

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.roi_align:multiscale_roi_align_backward_cuda"
KERNELS = ('roi_align_bwd_kernel',)


def count(grad, rois, level, level_shapes, dtype):
    """The gradient, rois and levels read (the cells written depend on
    the rois and are not counted)."""
    return 0, nbytes(grad) + nbytes(rois) + nbytes(level)

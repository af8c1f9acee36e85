"""Work item ``roi_align_fwd``: the kernels it launches and the least work a call
needs."""

from benchmark.roofline.work import nbytes

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.roi_align:multiscale_roi_align_cuda"
KERNELS = ('roi_align_fwd_kernel',)


def count(features, rois, level):
    """The rois and levels read, the pooled cells written (the cells the
    samples read depend on the rois and are not counted)."""
    b, c = features[0].shape[:2]
    out = b * rois.shape[1] * c * 49 * features[0].element_size()
    return 0, nbytes(rois) + nbytes(level) + out

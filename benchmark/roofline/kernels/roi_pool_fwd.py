"""Work item ``roi_pool_fwd``: the kernels it launches and the least work a call
needs."""

from benchmark.roofline.work import nbytes

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.roi_pool:roi_pool_cuda"
KERNELS = ('roi_pool_fwd_staged_kernel', 'roi_pool_fwd_direct_kernel')


def count(features, rois, spatial_scale=1.0, output_size=7, with_argmax=False):
    """The map read, the pooled cells written (and their int32 argmax)."""
    b, c = features.shape[:2]
    cells = b * rois.shape[1] * c * output_size * output_size
    out = cells * features.element_size() + (cells * 4 if with_argmax else 0)
    return 0, nbytes(features) + nbytes(rois) + out

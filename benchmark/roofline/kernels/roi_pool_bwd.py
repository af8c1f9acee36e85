"""Work item ``roi_pool_bwd``: the kernels it launches and the least work a call
needs."""

import math

from benchmark.roofline.work import nbytes, dtype_size

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.roi_pool:roi_pool_backward_cuda"
KERNELS = ('roi_pool_bwd_kernel',)


def count(grad, argmax, features_shape, dtype):
    """The gradient and the argmax read, the map's gradient written."""
    return 0, nbytes(grad) + nbytes(argmax) + math.prod(features_shape) * dtype_size(dtype)

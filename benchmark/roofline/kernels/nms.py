"""Work item ``nms``: the kernels it launches and the least work a call
needs."""

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.nms:nms_segments_cuda"
KERNELS = ('nms_segments_kernel',)


def count(boxes, valid, iou_threshold, post_k, width=None):
    """The segments' boxes and flags read, the kept positions and counts
    written (the pairs tested depend on the boxes and are not counted)."""
    s, n = boxes.shape[:2]
    return 0, s * n * 16 + s * n + s * post_k * 4 + s * 4

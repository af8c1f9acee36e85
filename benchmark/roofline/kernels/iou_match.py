"""Work item ``iou_match``: the kernels it launches and the least work a call
needs."""

from benchmark.roofline.work import nbytes, IOU_OPS

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.boxes:iou_match_cuda"
KERNELS = ('iou_match_kernel',)


def count(boxes, box_valid, gt, gt_mask, eps=1e-5):
    """Every candidate against every gt slot of its image; the boxes and
    masks read, each candidate's max and argmax written."""
    b, n = boxes.shape[:2]
    pairs = b * n * gt.shape[1]
    return pairs * IOU_OPS, nbytes(boxes) + nbytes(box_valid) + nbytes(gt) + nbytes(gt_mask) + b * n * 8

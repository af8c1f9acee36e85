"""Work item ``anchor_match``: the kernels it launches and the least work a call
needs."""

from benchmark.roofline.work import nbytes

FUNCTION = "faster_rcnn_pytorch_tpu_torch.ops.boxes:rpn_match_cuda"
KERNELS = ('anchor_match_pass1', 'anchor_match_ties', 'anchor_match_argmax')


def count(anchors, gt, gt_mask, inside, allow_ties, eps=1e-5):
    """Anchors, gt, masks read; each anchor's max, argmax and flag
    written (the pairs that intersect depend on the boxes)."""
    b, a = inside.shape
    return 0, nbytes(anchors) + nbytes(gt) + nbytes(gt_mask) + nbytes(inside) + b * a * 9

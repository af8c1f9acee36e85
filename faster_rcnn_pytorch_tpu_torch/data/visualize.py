"""Dataset / detection visualisation helpers.

The port's own copy of ``faster_rcnn_pytorch_tpu/data/visualize.py``.
matplotlib is imported inside :func:`draw_boxes_matplotlib` only, so this
module imports on a host without it.

Counterpart of the reference datasets' ``visualization=True`` matplotlib
mode (datasets/voc_dataset.py:169-209) and the demo's OpenCV drawing —
useful for eyeballing the augmentation pipeline and model outputs.
"""

from __future__ import annotations

import numpy as np


def draw_boxes_matplotlib(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray | None = None,
    class_names: tuple[str, ...] | None = None,
    scores: np.ndarray | None = None,
    save_path: str | None = None,
):
    """Plot an image with box overlays; save or show.

    image: uint8 HWC or float normalised; boxes: [n, 4] pixel xyxy.
    """
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = img.min(), img.max()
        img = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)

    fig, ax = plt.subplots(1, figsize=(8, 8))
    ax.imshow(img)
    cmap = plt.cm.hsv
    for i, box in enumerate(np.asarray(boxes)):
        lab = int(labels[i]) if labels is not None else 0
        color = cmap((lab * 37 % 255) / 255.0)
        x1, y1, x2, y2 = box
        ax.add_patch(
            plt.Rectangle(
                (x1, y1), x2 - x1, y2 - y1, fill=False, edgecolor=color, lw=2
            )
        )
        caption = ""
        if class_names is not None and labels is not None:
            caption = class_names[lab]
        if scores is not None:
            caption += f" {scores[i]:.2f}"
        if caption:
            ax.text(
                x1, y1 - 2, caption, color="black", fontsize=8,
                bbox=dict(facecolor=color, alpha=0.8, pad=1),
            )
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig

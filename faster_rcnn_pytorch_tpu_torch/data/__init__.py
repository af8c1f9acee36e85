"""Host-side data pipeline: datasets, transforms, padded-canvas batching.

A copy of ``faster_rcnn_pytorch_tpu/data/`` (numpy and Pillow host code)
with its imports pointed at the port, so the port's CLIs load VOC and
COCO without importing the JAX package. ``native.py`` binds the same
repo-level ``native/`` C library and keeps its numpy fallback.
"""

from faster_rcnn_pytorch_tpu_torch.data.loader import DetectionLoader, build_dataloader  # noqa: F401

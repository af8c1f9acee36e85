"""faster_rcnn_pytorch_tpu_torch — the PyTorch/CUDA port of
:mod:`faster_rcnn_pytorch_tpu` for NVIDIA Hopper GPUs.

Built slice by slice beside the JAX package, which stays the reference
it is tested against (``tests/test_torch_*.py``). Module names mirror the
JAX package's; tensors are NCHW inside, and every Pallas kernel on a
ported path is a hand-written CUDA kernel (``ops/cuda``) beside a plain
PyTorch twin. Nothing here imports jax or flax.
"""

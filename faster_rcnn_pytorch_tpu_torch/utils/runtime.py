"""Device and numerics set-up for the port's entry points."""

from __future__ import annotations

import os

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The port's counterpart of JAX_PLATFORMS=cpu: the CPU is an explicit choice.
DEVICE_ENV = "FRT_TORCH_DEVICE"


def select_device() -> torch.device:
    """The CLIs' device: the first CUDA card, or the CPU when
    ``FRT_TORCH_DEVICE=cpu`` asks for it. Without a card and without that
    choice it raises rather than carry on on the CPU unseen."""
    choice = os.environ.get(DEVICE_ENV, "cuda")
    if choice == "cpu":
        return torch.device("cpu")
    if choice != "cuda":
        raise ValueError(f"{DEVICE_ENV} must be 'cuda' or 'cpu', not {choice!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is visible; set {DEVICE_ENV}=cpu to run on the CPU"
        )
    return torch.device("cuda", 0)


def set_numerics(dtype: str) -> torch.dtype:
    """``--dtype`` -> the model's compute dtype, with TF32 switched off.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which would make a
    "float32" run multiply at about three decimal digits; both TF32
    switches are turned off so float32 means float32.
    """
    if dtype not in DTYPES:
        raise ValueError(f"--dtype must be one of {sorted(DTYPES)}, not {dtype!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return DTYPES[dtype]


def prepare_for_inference(model: torch.nn.Module, device, dtype: torch.dtype):
    """Move the model to ``device``, cast its weights once to ``dtype``
    and switch to eval mode (the JAX package's ``cast_inference_params``:
    a bfloat16 model holds bfloat16 weights; its heads return float32).

    FrozenBN buffers stay float32, as ``cast_inference_params`` leaves
    them: the module folds ``rsqrt(var + eps) * scale`` in float32 before
    casting to the activations' dtype, and a bfloat16 ``var`` would change
    that fold."""
    from faster_rcnn_pytorch_tpu_torch.models.resnet import FrozenBatchNorm2d

    model = model.to(device=device)
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm2d):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, buf in m.named_buffers(recurse=False):
            if buf.is_floating_point():
                setattr(m, name, buf.to(dtype))
    return model.eval()

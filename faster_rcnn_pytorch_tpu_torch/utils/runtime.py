"""Device and numerics set-up for the port's entry points."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def select_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU (tests)."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


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
    """Move and cast every parameter once (the JAX package's
    ``cast_inference_params``: a bfloat16 model holds bfloat16 weights;
    its heads return float32) and switch to eval mode."""
    return model.to(device=device, dtype=dtype).eval()

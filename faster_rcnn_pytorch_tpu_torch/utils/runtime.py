"""Device and numerics set-up for the port's entry points."""

from __future__ import annotations

import contextlib
import os

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The port's counterpart of JAX_PLATFORMS=cpu: the CPU is an explicit choice.
DEVICE_ENV = "FRT_TORCH_DEVICE"

_WEIGHTS = ("main", "test", "demo", "export")  # the JAX CLIs that call main.init_params

# Flags the port does not honour yet: the test on the options, the flag, the
# ROADMAP.md Queue A item that ports it, and the CLIs whose JAX counterparts
# honour it (each of those refuses it here rather than drop it unseen).
NOT_PORTED = (
    (lambda o: bool(o.pretrained_backbone), "--pretrained_backbone", "item 15", _WEIGHTS),
    (lambda o: o.checkpoint == "pretrained", "--checkpoint pretrained", "item 15", _WEIGHTS),
)


def refuse_unported(opts, cli: str) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP.md item for the
    first flag in ``opts`` that ``cli`` (``main``, ``test``, ``demo`` or
    ``export``) would have to honour and cannot yet. Each CLI calls it
    right after ``load_options``, before it reads data or weights."""
    for test, flag, item, clis in NOT_PORTED:
        if cli in clis and test(opts):
            raise NotImplementedError(
                f"{flag} is not ported to PyTorch yet; see ROADMAP.md Queue A {item}"
            )


def select_device(local_rank: int = 0) -> torch.device:
    """The CLIs' device: CUDA card ``local_rank`` (a rank's card on its
    host), or the CPU when ``FRT_TORCH_DEVICE=cpu`` asks for it. Without a
    card and without that choice it raises rather than carry on on the CPU
    unseen."""
    choice = os.environ.get(DEVICE_ENV, "cuda")
    if choice == "cpu":
        return torch.device("cpu")
    if choice != "cuda":
        raise ValueError(f"{DEVICE_ENV} must be 'cuda' or 'cpu', not {choice!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is visible; set {DEVICE_ENV}=cpu to run on the CPU"
        )
    return torch.device("cuda", local_rank)


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


MATMUL_PRECISIONS = ("default", "high", "highest")


def apply_matmul_precision(precision: str) -> None:
    """``--matmul_precision`` -> the torch switches of float32 products
    and convolutions (the JAX package's ``apply_matmul_precision``).

    ``default`` and ``highest`` keep TF32 off, as :func:`set_numerics`
    leaves it: float32 multiplies in float32 (on the TPU, the JAX
    package's ``default`` multiplies in bfloat16; the port's ``default``
    is float32 on purpose, so that float32 runs agree with the plain
    versions and with the JAX package on the CPU). ``high`` turns TF32 on
    for cuBLAS and cuDNN. Anything else raises.
    """
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"--matmul_precision must be one of {MATMUL_PRECISIONS}, not {precision!r}"
        )
    tf32 = precision == "high"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def _cast_weights(model: torch.nn.Module, dtype: torch.dtype) -> list:
    """Cast every parameter and floating buffer but FrozenBN's to
    ``dtype``, in place; returns ``(object, attribute, old value)`` to undo
    it with."""
    from faster_rcnn_pytorch_tpu_torch.models.resnet import FrozenBatchNorm2d

    undo = []
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm2d):
            continue
        for p in m.parameters(recurse=False):
            undo.append((p, "data", p.data))
            p.data = p.data.to(dtype)
        for name, buf in list(m.named_buffers(recurse=False)):
            if buf.is_floating_point():
                undo.append((m, name, buf))
                setattr(m, name, buf.to(dtype))
    return undo


@contextlib.contextmanager
def inference_weights(model: torch.nn.Module, dtype: torch.dtype | None):
    """The weights cast to ``dtype`` as :func:`prepare_for_inference`
    casts them, for the block only: the original tensors (a train run's
    float32 master weights, which the optimizer holds) are put back after
    it. ``None`` or the model's own dtype casts nothing."""
    if dtype is None or next(model.parameters()).dtype == dtype:
        yield model
        return
    undo = _cast_weights(model, dtype)
    try:
        yield model
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def prepare_for_inference(model: torch.nn.Module, device, dtype: torch.dtype):
    """Move the model to ``device``, cast its weights once to ``dtype``
    and switch to eval mode (the JAX package's ``cast_inference_params``:
    a bfloat16 model holds bfloat16 weights; its heads return float32).

    FrozenBN buffers stay float32, as ``cast_inference_params`` leaves
    them: the module folds ``rsqrt(var + eps) * scale`` in float32 before
    casting to the activations' dtype, and a bfloat16 ``var`` would change
    that fold."""
    model = model.to(device=device)
    _cast_weights(model, dtype)
    return model.eval()

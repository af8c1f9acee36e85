"""Weights into the port's legacy detector, with numpy only.

* :func:`legacy_state_dict_from_jax` turns the JAX package's
  ``LegacyFRCNN`` parameter tree (leaves as numpy arrays) into the port's
  state dict: conv kernels HWIO -> OIHW, dense kernels ``[in, out]`` ->
  ``[out, in]``, and fc6's input permuted from the ``(7, 7, C)`` flatten
  of NHWC pooling to the ``(C, 7, 7)`` flatten of NCHW pooling. It is the
  numpy twin of ``export_legacy_torch_state_dict``, which the port cannot
  import (that module imports flax).
* :func:`load_legacy_checkpoint` reads the reference layout (a
  ``.pth.tar`` blob as ``save_torch_checkpoint`` writes it, or a bare
  state dict; ``module.`` prefixes are stripped).
"""

from __future__ import annotations

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.models.vgg import TORCH_VGG16_CONV_INDICES

_CLASSIFIER_ALIASES = ("classifier", "fast_rcnn_head.classifier")


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _conv(w) -> np.ndarray:  # HWIO -> OIHW
    return np.ascontiguousarray(_f32(w).transpose(3, 2, 0, 1))


def _linear(w) -> np.ndarray:  # [in, out] -> [out, in]
    return np.ascontiguousarray(_f32(w).T)


def _linear_from_pool(w, ch: int = 512, pool: int = 7) -> np.ndarray:
    """fc over a (p, p, C) flatten -> fc over a (C, p, p) flatten."""
    out_dim = w.shape[1]
    w = _f32(w).reshape(pool, pool, ch, out_dim).transpose(3, 2, 0, 1)
    return np.ascontiguousarray(w.reshape(out_dim, ch * pool * pool))


def legacy_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``LegacyFRCNN`` params (``{"params": ...}`` or its root) ->
    the port's ``LegacyFRCNN`` state dict."""
    p = params["params"] if "params" in params else params
    sd: dict[str, np.ndarray] = {}
    for k, idx in enumerate(TORCH_VGG16_CONV_INDICES):
        conv = p["extractor"][f"conv{k}"]
        sd[f"extractor.{idx}.weight"] = _conv(conv["kernel"])
        sd[f"extractor.{idx}.bias"] = _f32(conv["bias"])
    for ours, theirs in (("inter", "inter_layer"), ("cls", "cls_layer"), ("reg", "reg_layer")):
        sd[f"rpn.{theirs}.weight"] = _conv(p["rpn"][ours]["kernel"])
        sd[f"rpn.{theirs}.bias"] = _f32(p["rpn"][ours]["bias"])
    trunk = {
        "0.weight": _linear_from_pool(p["fc6"]["kernel"]),
        "0.bias": _f32(p["fc6"]["bias"]),
        "2.weight": _linear(p["fc7"]["kernel"]),
        "2.bias": _f32(p["fc7"]["bias"]),
    }
    for prefix in _CLASSIFIER_ALIASES:
        for leaf, v in trunk.items():
            sd[f"{prefix}.{leaf}"] = v
    for head in ("cls_head", "reg_head"):
        sd[f"fast_rcnn_head.{head}.weight"] = _linear(p[head]["kernel"])
        sd[f"fast_rcnn_head.{head}.bias"] = _f32(p[head]["bias"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def load_legacy_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth``/``.pth.tar`` (``{"model_state_dict":
    ...}`` as ``save_torch_checkpoint`` writes it, or a bare state dict)
    -> the port's state dict."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob)
    return {
        k.removeprefix("module."): torch.as_tensor(v, dtype=torch.float32)
        for k, v in sd.items()
    }

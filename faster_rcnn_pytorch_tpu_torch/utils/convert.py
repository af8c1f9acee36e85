"""Weights into the port's detectors, with numpy only.

* :func:`legacy_state_dict_from_jax` and :func:`fpn_state_dict_from_jax`
  turn the JAX package's ``LegacyFRCNN`` / ``FPNFRCNN`` parameter trees
  (leaves as numpy arrays) into the port's state dicts: conv kernels
  HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``, fc6's input
  permuted from the ``(7, 7, C)`` flatten of NHWC pooling to the
  ``(C, 7, 7)`` flatten of NCHW pooling, and FrozenBN ``scale / bias /
  mean / var`` as ``weight / bias / running_mean / running_var`` plus an
  int64 ``num_batches_tracked``. They are the numpy twins of
  ``export_legacy_torch_state_dict`` / ``export_fpn_torch_state_dict``,
  which the port cannot import (that module imports flax).
* :func:`load_reference_checkpoint` reads the reference layout of either
  generation (a ``.pth.tar`` blob as ``save_torch_checkpoint`` writes it,
  or a bare state dict; ``module.`` prefixes are stripped).
"""

from __future__ import annotations

import numpy as np
import torch

from faster_rcnn_pytorch_tpu_torch.models.resnet import STAGE_SIZES
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


def _bn(sd: dict, prefix: str, bn: dict) -> None:
    sd[f"{prefix}.weight"] = _f32(bn["scale"])
    sd[f"{prefix}.bias"] = _f32(bn["bias"])
    sd[f"{prefix}.running_mean"] = _f32(bn["mean"])
    sd[f"{prefix}.running_var"] = _f32(bn["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def fpn_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``FPNFRCNN`` params (``{"params": ...}`` or its root) -> the
    port's ``FPNFRCNN`` state dict, key for key the one
    ``export_fpn_torch_state_dict`` writes."""
    p = params["params"] if "params" in params else params
    body = p["backbone"]["body"]
    sd: dict[str, np.ndarray] = {"backbone.body.conv1.weight": _conv(body["conv1"]["kernel"])}
    _bn(sd, "backbone.body.bn1", body["bn1"])
    for stage, blocks in enumerate(STAGE_SIZES):
        for b in range(blocks):
            blk = body[f"layer{stage + 1}_{b}"]
            t = f"backbone.body.layer{stage + 1}.{b}"
            for ci in (1, 2, 3):
                sd[f"{t}.conv{ci}.weight"] = _conv(blk[f"conv{ci}"]["kernel"])
                _bn(sd, f"{t}.bn{ci}", blk[f"bn{ci}"])
            if "down_conv" in blk:
                sd[f"{t}.downsample.0.weight"] = _conv(blk["down_conv"]["kernel"])
                _bn(sd, f"{t}.downsample.1", blk["down_bn"])
    fpn = p["backbone"]["fpn"]
    for i in range(4):
        for ours, theirs in (("lateral", "inner_blocks"), ("output", "layer_blocks")):
            sd[f"backbone.fpn.{theirs}.{i}.0.weight"] = _conv(fpn[f"{ours}{i}"]["kernel"])
            sd[f"backbone.fpn.{theirs}.{i}.0.bias"] = _f32(fpn[f"{ours}{i}"]["bias"])
    for ours, theirs in (("inter", "inter_layer"), ("cls", "cls_layer"), ("reg", "reg_layer")):
        sd[f"rpn.rpn_head.{theirs}.weight"] = _conv(p["rpn"][ours]["kernel"])
        sd[f"rpn.rpn_head.{theirs}.bias"] = _f32(p["rpn"][ours]["bias"])
    trunk = {
        "0.weight": _linear_from_pool(p["fc6"]["kernel"], ch=256),
        "0.bias": _f32(p["fc6"]["bias"]),
        "2.weight": _linear(p["fc7"]["kernel"]),
        "2.bias": _f32(p["fc7"]["bias"]),
    }
    for prefix in ("classifier", "frcnn_head.classifier"):
        for leaf, v in trunk.items():
            sd[f"{prefix}.{leaf}"] = v
    for head in ("cls_head", "reg_head"):
        sd[f"frcnn_head.{head}.weight"] = _linear(p[head]["kernel"])
        sd[f"frcnn_head.{head}.bias"] = _f32(p[head]["bias"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth``/``.pth.tar`` of either generation
    (``{"model_state_dict": ...}`` as ``save_torch_checkpoint`` writes it,
    or a bare state dict) -> the port's state dict: floating tensors as
    float32, integer buffers (``num_batches_tracked``) as they are."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob)
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v)
        out[k.removeprefix("module.")] = v.float() if v.is_floating_point() else v
    return out

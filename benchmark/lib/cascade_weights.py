"""Seeded weights of the cascade configuration, made on the device.

``lib/weights.py``'s distributions and draw order (one inverse-CDF draw
for every truncated normal, then one normal draw for the heads, sliced
in name order) over the cascade's parameter table, which that module's
``specs`` does not know: the heads N(0, std) with the configuration's
``head_stds`` (the RPN convs and each stage's class and box layers),
every other weight ``lecun_normal``, biases zero.
"""

from __future__ import annotations

import math

import torch

from benchmark.lib.weights import _CDF_HI, _CDF_LO, TRUNCATED_STD
from benchmark.reference.cascade import build


def specs(classes: int) -> list[tuple[str, tuple]]:
    """``(name, shape)`` of every parameter of the cascade, by name."""
    net = build(classes).to("meta")
    return sorted((n, tuple(p.shape)) for n, p in net.named_parameters())


def make(config: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for the cascade configuration from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    heads = config["head_stds"]
    table = specs(config["budgets"]["num_classes"])
    lecun = [(n, s) for n, s in table if n.endswith("weight") and n not in heads]
    normal = [(n, s) for n, s in table if n in heads]
    out = {n: torch.zeros(s, device=device) for n, s in table if n.endswith("bias")}

    total = sum(math.prod(s) for _, s in lecun)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (_CDF_LO + u * (_CDF_HI - _CDF_LO)) - 1.0)).float()
    del u
    at = 0
    for name, shape in lecun:
        k = math.prod(shape)
        std = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNCATED_STD
        out[name] = z[at : at + k].view(shape) * std
        at += k
    del z

    z = torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, device=device)
    at = 0
    for name, shape in normal:
        k = math.prod(shape)
        out[name] = z[at : at + k].view(shape) * heads[name]
        at += k
    return out

"""Seeded weights made on the device in a few large draws.

The distributions are the reference init of the JAX package's
``init_detector_params``: the heads N(0, std) with the configuration's
``head_stds``; every other convolution and linear weight flax's
``lecun_normal`` (a normal cut at two standard deviations, scaled to the
std ``sqrt(1 / fan_in)``); biases zero; frozen batch norm the identity.
All the truncated normals come from one inverse-CDF draw and all the head
normals from a second, sliced in name order, so the same seed gives the
same weights on any card. Both the program and the reference are filled
from the dictionary this returns.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.nets import build

# The std of a standard normal cut at +-2.
TRUNCATED_STD = 0.87962566103423978
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def specs(generation: str, classes: int) -> list[tuple[str, tuple]]:
    """``(name, shape)`` of every parameter of a generation, by name."""
    net = build(generation, classes).to("meta")
    return sorted((n, tuple(p.shape)) for n, p in net.named_parameters())


def make(config: dict, seed: int, device, scales: dict | None = None) -> dict:
    """``{name: float32 tensor}`` for the configuration's generation from
    ``seed``; ``scales`` multiplies named weights after the draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    heads = config["head_stds"]
    table = specs(config["generation"], config["budgets"]["num_classes"])
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

    total = sum(math.prod(s) for _, s in normal)
    z = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, shape in normal:
        k = math.prod(shape)
        out[name] = z[at : at + k].view(shape) * heads[name]
        at += k
    for name, factor in (scales or {}).items():
        out[name] = out[name] * factor
    return out


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the model's parameters by name; raise unless
    the names match one for one."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"weights and model differ in {sorted(set(params) ^ set(weights))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])

"""Megatron tensor parallelism of the RoI head's fc6/fc7 pair.

Counterpart of ``faster_rcnn_pytorch_tpu/parallel/mesh.py::_tp_spec``:
fc6 is column-parallel (its output features split over the model group:
weight rows and bias), fc7 row-parallel (its input features split:
weight columns; the bias is added once, after the reduce). Everything
else is replicated. Two autograd functions carry the model group's
collectives, as in Megatron-LM: :class:`_CopyToModel` (identity forward,
all-reduce backward) before fc6, and :class:`_ReduceFromModel`
(all-reduce forward, identity backward) after fc7's product.

A split parameter carries ``tp_dim``, the dimension it is split along.
:func:`gather_state_dict` and :func:`shard_state_dict` move between the
split layout and the single-device one, which every checkpoint holds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shard(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    return t.chunk(size, dim)[rank].clone()


class ColumnParallelLinear(nn.Module):
    """fc6: ``out_features / size`` of the outputs on each rank."""

    def __init__(self, full: nn.Linear, group, rank: int, size: int):
        super().__init__()
        if full.out_features % size:
            raise ValueError(f"model_parallel {size} must divide fc6's {full.out_features} outputs")
        self.group = group
        self.in_features, self.out_features = full.in_features, full.out_features
        self.weight = nn.Parameter(_shard(full.weight.data, 0, rank, size))
        self.bias = nn.Parameter(_shard(full.bias.data, 0, rank, size))
        self.weight.tp_dim = self.bias.tp_dim = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        return nn.functional.linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """fc7: ``in_features / size`` of the inputs on each rank; the partial
    products are summed over the model group, then the bias is added."""

    def __init__(self, full: nn.Linear, group, rank: int, size: int):
        super().__init__()
        if full.in_features % size:
            raise ValueError(f"model_parallel {size} must divide fc7's {full.in_features} inputs")
        self.group = group
        self.in_features, self.out_features = full.in_features, full.out_features
        self.weight = nn.Parameter(_shard(full.weight.data, 1, rank, size))
        self.bias = nn.Parameter(full.bias.data.clone())
        self.weight.tp_dim = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(nn.functional.linear(x, self.weight), self.group)
        return y + self.bias


def _head(model) -> nn.Module:
    return model.fast_rcnn_head if hasattr(model, "fast_rcnn_head") else model.frcnn_head


def apply_tensor_parallel(model: nn.Module, group, rank: int, size: int) -> nn.Module:
    """Split ``model``'s fc6/fc7 (``classifier[0]`` and ``[2]``) over the
    model group, in place; the classifier stays registered under both of
    its names, with the same parameter names. ``rank``/``size``: this
    process's place in the model group. Returns ``model``."""
    if size == 1:
        return model
    if not hasattr(model, "classifier"):
        raise ValueError("--model_parallel splits the one RoI head's fc6/fc7; a cascade has three")
    old = model.classifier
    new = nn.Sequential(
        ColumnParallelLinear(old[0], group, rank, size),
        nn.ReLU(inplace=True),
        RowParallelLinear(old[2], group, rank, size),
        nn.ReLU(inplace=True),
    )
    model.classifier = new
    _head(model).classifier = new
    return model


def split_parameters(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """The split parameters, ``(name, parameter)``, each once."""
    return [(n, p) for n, p in model.named_parameters() if hasattr(p, "tp_dim")]


def _split_dims(model: nn.Module) -> dict[str, tuple[int, nn.Parameter]]:
    """Every state-dict name of a split parameter (both classifier
    aliases) -> its split dimension and the parameter."""
    return {
        n: (p.tp_dim, p)
        for n, p in model.named_parameters(remove_duplicate=False)
        if hasattr(p, "tp_dim")
    }


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def gather_state_dict(model: nn.Module, group, state: dict | None = None) -> dict:
    """The single-device state dict of a split model: each split entry of
    ``state`` (default ``model.state_dict()``) gathered over the model
    group. A collective: every rank of the group calls it."""
    state = dict(model.state_dict() if state is None else state)
    if group is None:
        return state
    done: dict[int, torch.Tensor] = {}  # one gather for both aliases
    for name, (dim, p) in _split_dims(model).items():
        if name in state:
            if id(p) not in done:
                done[id(p)] = _gather(state[name], dim, group)
            state[name] = done[id(p)]
    return state


def shard_state_dict(model: nn.Module, state: dict, rank: int, size: int) -> dict:
    """This rank's slice of a single-device state dict for a model split
    by :func:`apply_tensor_parallel` (the inverse of
    :func:`gather_state_dict`)."""
    out = dict(state)
    if size == 1:
        return out
    for name, (dim, _) in _split_dims(model).items():
        out[name] = _shard(state[name], dim, rank, size)
    return out


def _momentum_dims(model: nn.Module, optimizer) -> dict[int, int]:
    """Optimizer state index -> split dimension, for the split parameters."""
    split = {id(p): p.tp_dim for _, p in split_parameters(model)}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: split[id(p)] for i, p in enumerate(params) if id(p) in split}


def gather_optimizer_state(model, optimizer, group) -> dict:
    """``optimizer.state_dict()`` with the split parameters' momentum
    gathered over the model group (a collective)."""
    sd = optimizer.state_dict()
    if group is None:
        return sd
    state = {i: dict(s) for i, s in sd["state"].items()}
    for i, dim in _momentum_dims(model, optimizer).items():
        if "momentum_buffer" in state.get(i, {}):
            state[i]["momentum_buffer"] = _gather(state[i]["momentum_buffer"], dim, group)
    return {**sd, "state": state}


def shard_optimizer_state(model, optimizer, sd: dict, rank: int, size: int) -> dict:
    """This rank's slice of a single-device optimizer state dict."""
    if size == 1:
        return sd
    state = {i: dict(s) for i, s in sd["state"].items()}
    for i, dim in _momentum_dims(model, optimizer).items():
        if "momentum_buffer" in state.get(i, {}):
            state[i]["momentum_buffer"] = _shard(state[i]["momentum_buffer"], dim, rank, size)
    return {**sd, "state": state}

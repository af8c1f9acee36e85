"""Train step on one device: SGD with momentum and weight decay, LR schedules.

Counterpart of ``faster_rcnn_pytorch_tpu/parallel/train_step.py``. The
JAX package's ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``
is ``torch.optim.SGD(lr, momentum, weight_decay=wd, nesterov=False)``:
both add ``wd * p`` to the gradient, keep ``trace = g + momentum *
trace`` (the first trace is the gradient) and step by ``-lr * trace``.
optax updates every parameter: one the loss does not reach (the frozen
``conv1`` and ``layer1`` of the FPN generation) takes a zero gradient plus
``wd * p`` and momentum, so :func:`apply_gradients` gives such a
parameter a zero ``.grad`` (``torch.optim.SGD`` would skip it).

Data parallelism (``parallel/mesh.py``: a process group is up) wraps the
model in ``DistributedDataParallel`` so that every step equals the JAX
package's SPMD step on the same global batch:

* the loss's counts are summed over the data group before the division
  and each rank's terms are scaled by the data world size
  (``models/losses.py``), so DDP's mean of the gradients is the gradient
  of the global-batch mean;
* the sampling noise is drawn for the global batch from the epoch's
  generator and each rank takes its own rows, so the targets do not
  depend on the world size;
* the frozen FPN stem and ``layer1`` (``model.frozen_prefixes``) are left
  out of DDP's reducer: they never have a gradient, take the zero one of
  :func:`apply_gradients` and decay identically on every rank;
* DDP reduces the replicated parameters over every rank; the fc6/fc7
  shards of tensor parallelism are left out of it and reduced over the
  data group only. A replicated gradient that two ranks of a model group
  computed with atomics in another order is so averaged to the same bits
  on both, and no replica drifts;
* with ``grad_accum`` the micro-batches but the last run under
  ``no_sync``; the metrics are reduced to the global batch's values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (
    TrainNoise,
    device_anchors,
    draw_train_noise,
    forward_train,
)
from faster_rcnn_pytorch_tpu_torch.parallel.mesh import layout
from faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel import split_parameters
from faster_rcnn_pytorch_tpu_torch.utils.logging import span

METRIC_KEYS = (
    "loss",
    "rpn_cls",
    "rpn_reg",
    "roi_cls",
    "roi_reg",
    "num_pos_roi",
    "num_pos_rpn",
)


@dataclasses.dataclass
class TrainState:
    """The model (float32 master weights), its optimizer and the count of
    optimizer steps taken, which indexes the LR schedule."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def decays(name: str) -> bool:
    """``_decay_mask``'s rule: weight decay everywhere except parameters
    under a ``bn*`` or ``down_bn*`` name (frozen batch-norm statistics)."""
    return not any(part.startswith(("bn", "down_bn")) for part in name.split("."))


def make_lr_schedule(
    kind: str,
    base_lr: float,
    epochs: int,
    steps_per_epoch: int,
    milestones: tuple[int, ...] = (16, 22),
    eta_min: float = 5e-5,
    warmup_epochs: int = 0,
    gamma: float = 0.1,
    cycle_mult: float = 1.0,
    restart_gamma: float = 1.0,
    first_cycle_epochs: int = 0,
) -> Callable[[int], float]:
    """``schedule(step) -> lr`` for 'cosine', 'multistep', 'constant' and
    'cosine_warmup_restarts', each formula as in the JAX package
    (optional linear warmup over ``warmup_epochs``; the restarts kind
    follows the reference's CosineAnnealingWarmupRestarts)."""
    warm = warmup_epochs * steps_per_epoch
    total = max(epochs * steps_per_epoch, 1)
    if kind not in ("cosine", "multistep", "constant", "cosine_warmup_restarts"):
        raise ValueError(f"unknown schedule {kind!r}")
    if kind == "cosine_warmup_restarts":
        if cycle_mult < 1.0:
            raise ValueError("cycle_mult < 1 unsupported")
        first = max((first_cycle_epochs or epochs) * steps_per_epoch, 1)
        if warm >= first:
            raise ValueError("warmup must be shorter than the first cycle")
        starts, lens = [0], [first]
        while starts[-1] + lens[-1] <= total and len(lens) < 64:
            starts.append(starts[-1] + lens[-1])
            lens.append(int((lens[-1] - warm) * cycle_mult) + warm)

    def restarts(step: float) -> float:
        k = sum(step >= s for s in starts[1:])
        s_in = step - starts[k]
        max_lr = base_lr * restart_gamma**k
        t = (s_in - warm) / max(lens[k] - warm, 1.0)
        cos_lr = eta_min + 0.5 * (max_lr - eta_min) * (1 + math.cos(math.pi * t))
        if not warm:
            # The reference's init_lr() sets step 0 to min_lr.
            return eta_min if step < 1 else cos_lr
        if s_in < warm:
            return (max_lr - eta_min) * s_in / warm + eta_min
        return cos_lr

    def schedule(step: int) -> float:
        step = float(step)
        if kind == "cosine_warmup_restarts":
            return restarts(step)
        if kind == "cosine":
            t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
            lr = eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * t))
        elif kind == "multistep":
            epoch = step / steps_per_epoch
            lr = base_lr * gamma ** sum(epoch >= m for m in milestones)
        else:
            lr = base_lr
        if warm and step < warm:
            return base_lr * (step + 1) / warm
        return lr

    return schedule


def make_optimizer(
    model: torch.nn.Module, momentum: float = 0.9, weight_decay: float = 5e-4
) -> torch.optim.SGD:
    """SGD with L2-into-gradient weight decay on every parameter that
    :func:`decays`. The learning rate is set per step by the train step."""
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if decays(n)], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not decays(n)], "weight_decay": 0.0},
    ]
    return torch.optim.SGD(
        [g for g in groups if g["params"]], lr=0.0, momentum=momentum, nesterov=False
    )


def init_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def apply_gradients(state: TrainState, schedule: Callable[[int], float]) -> float:
    """One optimizer update from the gradients in ``.grad``, at the
    learning rate ``schedule(step)`` with ``step`` counted from 0 before
    the increment (as optax does). A parameter without a gradient takes a
    zero one. Returns that rate."""
    lr = schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
    return lr


class TrainForward(nn.Module):
    """``forward_train`` as a module's ``forward``, so that DDP, which
    wraps this module, sees every step's forward (its reducer readies the
    backward's gradient hooks there)."""

    def __init__(self, model: nn.Module, cfg, count_reduce=None):
        super().__init__()
        self.model, self.cfg, self.count_reduce = model, cfg, count_reduce

    def forward(self, batch: dict, noise):
        return forward_train(
            self.model,
            self.cfg,
            batch["image"],
            batch["extent"],
            batch["gt_boxes"],
            batch["gt_labels"],
            batch["gt_mask"],
            noise=noise,
            count_reduce=self.count_reduce,
        )


def data_group_count_reduce(counts: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The loss's counts summed over the data group (no gradient) and the
    data world size: ``models/losses.py``'s ``count_reduce``."""
    lay = layout()
    counts = counts.detach().clone()
    dist.all_reduce(counts, group=lay.data_group)
    return counts, lay.data_size


def _frozen(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    prefixes = getattr(model, "frozen_prefixes", ())
    return [(n, p) for n, p in model.named_parameters() if n.startswith(prefixes)]


def wrap_ddp(model: nn.Module, cfg) -> nn.Module:
    """``TrainForward(model)`` under DDP over every rank, without the
    frozen parameters and the tensor-parallel shards (which
    :func:`make_train_step` reduces over the data group). Collective."""
    from torch.nn.parallel import DistributedDataParallel

    module = TrainForward(model, cfg, data_group_count_reduce)
    left_out = [f"model.{n}" for n, _ in _frozen(model) + split_parameters(model)]
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(module, left_out)
    device = next(model.parameters()).device
    return DistributedDataParallel(
        module,
        device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False,  # FrozenBN statistics never change
    )


def batch_noise(model, cfg, generator, images, gt_boxes, rows: tuple[int, int]):
    """The sampling noise of this rank's ``images`` as rows ``[lo, lo +
    b)`` of a global batch of ``rows[1]`` images: the global batch's noise
    is drawn (as one process drawing for all of it would) and sliced.
    ``generator`` may also be the global batch's ``TrainNoise`` itself (a
    test feeding the JAX package's)."""
    lo, total = rows
    b, canvas_h, canvas_w = images.shape[:3]
    dev = images.device
    if isinstance(generator, TrainNoise):
        noise = generator
    else:
        n_anchors = device_anchors(model, canvas_h, canvas_w, dev).shape[0]
        noise = draw_train_noise(generator, cfg, total, n_anchors, gt_boxes.shape[1], dev)
    if total == b:
        return noise
    return type(noise)(*(t[lo : lo + b] for t in noise))


def make_train_step(
    cfg,
    schedule: Callable[[int], float],
    grad_accum: int = 1,
    autocast_dtype: torch.dtype | None = None,
):
    """``step_fn(state, batch, generator) -> metrics``: forward, backward
    and one SGD update, in place on ``state``.

    ``batch`` holds the loader's ``image``, ``extent``, ``gt_boxes``,
    ``gt_labels`` and ``gt_mask`` as tensors on the model's device (this
    rank's rows of the global batch under data parallelism);
    ``generator`` draws the sampling noise. ``grad_accum > 1`` takes
    interleaved micro-batches ``batch[i::grad_accum]``, sums their
    gradients and divides by ``grad_accum`` before the one update; the
    metrics are then micro-batch means. ``autocast_dtype`` (bfloat16)
    runs the forward under ``torch.autocast`` over the float32 master
    weights; the losses stay float32. The metrics (``METRIC_KEYS``) are
    0-d tensors on the device, so reading them is the caller's choice of
    sync point; under data parallelism they are the global batch's (the
    losses' mean and the positives' sum over the data group).

    With a process group up (``parallel/mesh.py``) the step runs the model
    under DDP (module docstring), made at the first call.

    Each call is the program's span ``train.step`` (``utils/logging.py``),
    one step id, around ``train.backward`` and ``train.update`` and the
    forward's spans (``forward_train``), once a micro-batch.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, not {grad_accum}")
    lay = layout()
    wrapped: dict[int, nn.Module] = {}

    def forward(state: TrainState):
        if not lay.distributed:
            return TrainForward(state.model, cfg)
        if id(state.model) not in wrapped:
            wrapped.clear()
            wrapped[id(state.model)] = wrap_ddp(state.model, cfg)
        return wrapped[id(state.model)]

    def loss_and_backward(fwd, model, batch, generator):
        b = batch["image"].shape[0]
        noise = batch_noise(
            model, cfg, generator, batch["image"], batch["gt_boxes"],
            (lay.data_rank * b, lay.data_size * b),
        )
        dev_type = batch["image"].device.type
        autocast = (
            torch.autocast(dev_type, dtype=autocast_dtype)
            if autocast_dtype is not None
            else contextlib.nullcontext()
        )
        with autocast:
            out = fwd(batch, noise)
        with span("train.backward"):
            out.losses.total.backward()
        return torch.stack(
            [
                *(t.detach().float() for t in out.losses),
                out.num_pos_roi.float(),
                out.num_pos_rpn.float(),
            ]
        )

    def step_fn(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        with span("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            fwd = forward(state)
            if grad_accum == 1:
                values = loss_and_backward(fwd, state.model, batch, generator)
            else:
                values = 0
                for i in range(grad_accum):
                    micro = {k: v[i::grad_accum] for k, v in batch.items()}
                    last = i == grad_accum - 1
                    sync = (
                        contextlib.nullcontext() if last or not lay.distributed else fwd.no_sync()
                    )
                    with sync:
                        values = values + loss_and_backward(fwd, state.model, micro, generator)
                values = values / grad_accum
            if lay.distributed:
                _reduce_outside_ddp(state.model, lay)
                values = values.clone()
                dist.all_reduce(values, group=lay.data_group)
                values[:5] /= lay.data_size
            if grad_accum > 1:
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
            with span("train.update"):
                apply_gradients(state, schedule)
            return dict(zip(METRIC_KEYS, values.unbind()))

    return step_fn


def _reduce_outside_ddp(model: nn.Module, lay) -> None:
    """The gradients DDP does not reduce: the tensor-parallel shards,
    averaged over the data group. The frozen parameters must have none
    (else DDP's reducer would have to see them)."""
    for name, p in _frozen(model):
        if p.grad is not None:
            raise RuntimeError(f"{name} is frozen (model.frozen_prefixes) but has a gradient")
    for _, p in split_parameters(model):
        dist.all_reduce(p.grad, group=lay.data_group)
        p.grad.div_(lay.data_size)

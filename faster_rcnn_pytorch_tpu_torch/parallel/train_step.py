"""Train step on one device: SGD with momentum and weight decay, LR schedules.

Counterpart of ``faster_rcnn_pytorch_tpu/parallel/train_step.py``. The
JAX package's ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``
is ``torch.optim.SGD(lr, momentum, weight_decay=wd, nesterov=False)``:
both add ``wd * p`` to the gradient, keep ``trace = g + momentum *
trace`` (the first trace is the gradient) and step by ``-lr * trace``.
optax updates every parameter: one the loss does not reach (the frozen
``conv1`` and ``layer1`` of the FPN generation) takes a zero gradient plus
``wd * p`` and momentum, so :func:`apply_gradients` gives such a
parameter a zero ``.grad`` (``torch.optim.SGD`` would skip it). There is
no mesh here: data parallelism is a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch

from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import forward_train

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


def make_train_step(
    cfg,
    schedule: Callable[[int], float],
    grad_accum: int = 1,
    autocast_dtype: torch.dtype | None = None,
):
    """``step_fn(state, batch, generator) -> metrics``: forward, backward
    and one SGD update, in place on ``state``.

    ``batch`` holds the loader's ``image``, ``extent``, ``gt_boxes``,
    ``gt_labels`` and ``gt_mask`` as tensors on the model's device;
    ``generator`` draws the sampling noise. ``grad_accum > 1`` takes
    interleaved micro-batches ``batch[i::grad_accum]``, sums their
    gradients and divides by ``grad_accum`` before the one update; the
    metrics are then micro-batch means. ``autocast_dtype`` (bfloat16)
    runs the forward under ``torch.autocast`` over the float32 master
    weights; the losses stay float32. The metrics (``METRIC_KEYS``) are
    0-d tensors on the device, so reading them is the caller's choice of
    sync point.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, not {grad_accum}")

    def loss_and_backward(model, batch, generator):
        dev_type = batch["image"].device.type
        autocast = (
            torch.autocast(dev_type, dtype=autocast_dtype)
            if autocast_dtype is not None
            else contextlib.nullcontext()
        )
        with autocast:
            out = forward_train(
                model,
                cfg,
                batch["image"],
                batch["extent"],
                batch["gt_boxes"],
                batch["gt_labels"],
                batch["gt_mask"],
                generator=generator,
            )
        out.losses.total.backward()
        return torch.stack(
            [
                *(t.detach().float() for t in out.losses),
                out.num_pos_roi.float(),
                out.num_pos_rpn.float(),
            ]
        )

    def step_fn(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            values = loss_and_backward(state.model, batch, generator)
        else:
            values = sum(
                loss_and_backward(
                    state.model, {k: v[i::grad_accum] for k, v in batch.items()}, generator
                )
                for i in range(grad_accum)
            ) / grad_accum
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        apply_gradients(state, schedule)
        return dict(zip(METRIC_KEYS, values.unbind()))

    return step_fn

"""The system under test: the port's model, train step and predict, built
as its CLIs build them. This is the only harness module that imports the
port; the reference never does."""

from __future__ import annotations

import torch

from benchmark.lib.weights import load_into


def load_kernels(device: torch.device) -> None:
    """Build or load the port's CUDA extension (its fixed
    ``build/torch_kernels/`` inside the checkout)."""
    if device.type == "cuda":
        from faster_rcnn_pytorch_tpu_torch.ops.cuda import extension

        extension()


def build(config: dict, weights: dict, device):
    """The port's model of the configuration's generation on ``device``
    with ``weights`` (float32), and its ``DetectorConfig``."""
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model

    model, cfg = build_model(config["generation"], num_classes=config["budgets"]["num_classes"])
    model = model.to(device)
    load_into(model, weights)
    return model, cfg


class Train:
    """``make_train_step``'s step over the port's SGD state."""

    def __init__(self, config: dict, weights: dict, device):
        from faster_rcnn_pytorch_tpu_torch.parallel.train_step import (
            init_train_state,
            make_lr_schedule,
            make_optimizer,
            make_train_step,
        )
        from faster_rcnn_pytorch_tpu_torch.utils.runtime import set_numerics

        dtype = set_numerics(config["dtype"])
        self.model, self.cfg = build(config, weights, device)
        opt = config["optimizer"]
        self.optimizer = make_optimizer(self.model, opt["momentum"], opt["weight_decay"])
        self.state = init_train_state(self.model, self.optimizer)
        schedule = make_lr_schedule("constant", opt["lr"], 1, 1)
        self.step_fn = make_train_step(
            self.cfg, schedule, autocast_dtype=None if dtype == torch.float32 else dtype
        )

    def step(self, batch: dict, generator: torch.Generator) -> dict:
        return self.step_fn(self.state, batch, generator)

    def first_directions(self) -> dict:
        """Each leaf's norm of its update direction in the first step,
        from the optimizer's momentum after that step (0 where it holds
        none)."""
        out = {}
        for name, p in self.model.named_parameters():
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            out[name] = 0.0 if buf is None else float(buf.float().norm())
        return out


class Predict:
    """``predict`` on ``prepare_for_inference``'s model, the detections
    packed and copied to the host as the eval loop does."""

    def __init__(self, config: dict, weights: dict, device):
        from faster_rcnn_pytorch_tpu_torch.utils.runtime import DTYPES, prepare_for_inference, set_numerics

        set_numerics(config["dtype"])
        model, self.cfg = build(config, weights, device)
        self.model = prepare_for_inference(model, device, DTYPES[config["dtype"]])
        self.threshold = config["budgets"]["score_threshold"]

    def dispatch(self, images, extents, on_stage=None):
        from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import predict

        return predict(self.model, self.cfg, images, extents, self.threshold, on_stage=on_stage)

    @staticmethod
    def to_host(det):
        from faster_rcnn_pytorch_tpu_torch.serving import pack_detections

        return pack_detections(det).cpu().numpy()

"""Where the PyTorch port's train step spends its time on one GPU.

Drives ``chip_smoke.py``'s full-width train configuration of either
generation (``--generation legacy``: VGG16, 21 classes, ``LEGACY_CONFIG``
budgets; ``--generation fpn``: ResNet50-FPN, 91 classes, raw COCO ids,
``FPN_CONFIG`` budgets; both with seeded random weights, the 800x1344
canvas, batch 2 and one repeated synthetic batch; ``--dense``: the smoke's
dense scene, gt padded to 512 slots with 300-500 boxes an image, where
the RoI targets' IoU runs through its kernel's match mode, once a step)
and prints, per dtype (float32 with TF32 off, bfloat16 autocast):

1. rate: ``--repeats`` runs of 20 steps of ``make_train_step``
   from the same weights and generator seed, each step timed to a device
   sync as ``chip_smoke.py`` times it: img/s over the steps after the
   ``--warmup`` (5; steps 6 on, as the smoke counts them), step p50,
   and the number of NMS tile-fixpoint sweeps (each one a host sync) in
   those steps, with both per step;
2. stages: the same steps with a device sync between backbone + RPN
   forward, propose + targets, head + loss forward, backward and the SGD
   update, once with cuDNN deterministic (as the smoke runs) and once with
   its defaults (as the CLIs run; once only on the CPU): the median per
   stage over the steps after the warm-up;
3. busy share: ``torch.profiler`` over 3 whole steps, device kernel time
   (user annotations excluded) over wall time, and the top kernels.

The phases run in that order, every rate before the first profiler
session. Run from the root of a checkout on a GPU host:
``python tools/torch_train_stages.py [--generation legacy|fpn] [--dense]
[--repeats 3] [--phases rate,stages,profile] [--steps 20] [--warmup 5]
[--dtypes float32,bfloat16]``.
Without a card it raises; with ``FRT_TORCH_DEVICE=cpu`` it runs on the
CPU at a small canvas (``--canvas 192 256``, ``--steps 2 --warmup 1``),
without the profiler, to check the script itself.
"""

from __future__ import annotations

import argparse
import os
import platform
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.engine.train import epoch_generator  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import (  # noqa: E402
    draw_train_noise,
    train_losses,
    train_targets,
)
from faster_rcnn_pytorch_tpu_torch.ops import nms as nms_mod  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.parallel.train_step import (  # noqa: E402
    apply_gradients,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from faster_rcnn_pytorch_tpu_torch.utils.runtime import select_device, set_numerics  # noqa: E402


def host_line() -> str:
    model = platform.processor() or "?"
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            names = [ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")]
        model = names[0] if names else model
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    return f"host: {model}, {os.cpu_count()} cpus, load average {load}"


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def _steady_summary(times, sweeps, batch_size, skip) -> str:
    t, s = times[skip:], sweeps[skip:]
    return (
        f"{batch_size * len(t) / sum(t):.2f} img/s over steps {skip + 1}-{len(times)} "
        f"(step p50 {1000 * statistics.median(t):.1f} ms, min {1000 * min(t):.1f}, "
        f"max {1000 * max(t):.1f}), NMS sweeps {sum(s)} (per step {min(s)}-{max(s)})"
    )


def run_rate(model, init, cfg, dtype, device, batch, steps, repeats, warmup) -> None:
    name = str(dtype).removeprefix("torch.")
    schedule = make_lr_schedule("constant", cs.TRAIN_LR, 1, steps)
    step_fn = make_train_step(cfg, schedule, autocast_dtype=None if dtype == torch.float32 else dtype)
    for r in range(repeats):
        model.load_state_dict(init)
        state = init_train_state(model, make_optimizer(model))
        gen = epoch_generator(cs.SEED, 0, device)
        times, sweeps, losses = [], [], []
        for _ in range(steps):
            nms_mod._tile_fixpoint.sweeps = 0
            t0 = _sync(device)
            metrics = step_fn(state, batch, gen)
            times.append(_sync(device) - t0)
            sweeps.append(nms_mod._tile_fixpoint.sweeps)
            losses.append(float(metrics["loss"]))
        print(
            f"rate {name} run {r + 1}/{repeats}: "
            f"{_steady_summary(times, sweeps, cs.TRAIN_BATCH, warmup)}, "
            f"loss step 1 {losses[0]:.4f} -> step {steps} {losses[-1]:.4f}",
            flush=True,
        )
        print(
            f"  per step ms: {' '.join(f'{1000 * t:.0f}' for t in times)}\n"
            f"  per step sweeps: {' '.join(str(s) for s in sweeps)}",
            flush=True,
        )


def run_stages(model, init, cfg, dtype, device, batch, steps, warmup, deterministic: bool) -> None:
    torch.backends.cudnn.deterministic = deterministic
    name = str(dtype).removeprefix("torch.")
    model.load_state_dict(init)
    state = init_train_state(model, make_optimizer(model))
    schedule = make_lr_schedule("constant", cs.TRAIN_LR, 1, steps)
    canvas_hw = tuple(batch["image"].shape[1:3])
    anchors = torch.from_numpy(model.canvas_anchors(*canvas_hw)).to(device)
    n_cand = cfg.post_nms_train + batch["gt_boxes"].shape[1]
    gen = epoch_generator(cs.SEED, 0, device)
    autocast = torch.autocast(device.type, dtype=torch.bfloat16, enabled=dtype != torch.float32)
    rows, sweeps, iou_launches = [], [], [cs._iou_launches()]
    for _ in range(steps):
        nms_mod._tile_fixpoint.sweeps = 0
        t0 = _sync(device)
        state.optimizer.zero_grad(set_to_none=True)
        with autocast:
            feats = model.features(batch["image"].permute(0, 3, 1, 2).contiguous())
            rpn_cls, rpn_reg = model.rpn_out(feats)
            t1 = _sync(device)
            noise = draw_train_noise(gen, cs.TRAIN_BATCH, anchors.shape[0], n_cand, device)
            targets = train_targets(
                cfg, anchors, rpn_cls, rpn_reg, *(batch[k] for k in cs.BATCH_KEYS[1:]), noise
            )
            t2 = _sync(device)
            out = train_losses(model, cfg, feats, rpn_cls, rpn_reg, *targets, canvas_hw)
            t3 = _sync(device)
        out.losses.total.backward()
        t4 = _sync(device)
        apply_gradients(state, schedule)
        t5 = _sync(device)
        rows.append([t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t5 - t0])
        iou_launches.append(cs._iou_launches())
        sweeps.append(nms_mod._tile_fixpoint.sweeps)
    med = [1000 * statistics.median(r[i] for r in rows[warmup:]) for i in range(6)]
    print(
        f"stages {name} cudnn deterministic={deterministic}, ms per step (median of steps "
        f"{warmup + 1}-{steps}): backbone+rpn fwd {med[0]:.2f}, propose+targets {med[1]:.2f}, "
        f"head+loss fwd {med[2]:.2f}, backward {med[3]:.2f}, sgd {med[4]:.2f}, total {med[5]:.2f}; "
        f"NMS sweeps per step {min(sweeps[warmup:])}-{max(sweeps[warmup:])}; "
        f"IoU kernel launches {iou_launches[-1] - iou_launches[0]} in {steps} steps",
        flush=True,
    )


def run_profile(model, init, cfg, dtype, device, batch) -> None:
    name = str(dtype).removeprefix("torch.")
    model.load_state_dict(init)
    state = init_train_state(model, make_optimizer(model))
    schedule = make_lr_schedule("constant", cs.TRAIN_LR, 1, 10)
    step_fn = make_train_step(cfg, schedule, autocast_dtype=None if dtype == torch.float32 else dtype)
    gen = epoch_generator(cs.SEED, 0, device)
    for _ in range(2):
        step_fn(state, batch, gen)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = _sync(device)
        for _ in range(3):
            step_fn(state, batch, gen)
        wall = _sync(device) - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", 0)

    kernels = [
        e
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith(("Optimizer.", "ProfilerStep"))
    ]
    busy_us = sum(device_us(e) for e in kernels)
    print(
        f"profile {name} cudnn deterministic={torch.backends.cudnn.deterministic}: wall "
        f"{1000 * wall / 3:.2f} ms/step (profiler on), device kernel time {busy_us / 3000:.2f} "
        f"ms/step, busy share {busy_us / 1e6 / wall:.3f}",
        flush=True,
    )
    for e in sorted(kernels, key=lambda e: -device_us(e))[:10]:
        print(f"  {device_us(e) / 3000:8.3f} ms/step  {e.key[:100]}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--generation", choices=("legacy", "fpn"), default="legacy")
    p.add_argument("--canvas", type=int, nargs=2, default=list(cs.CANVAS))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--phases", default="rate,stages,profile")
    p.add_argument("--steps", type=int, default=cs.TRAIN_STEPS, help="steps per run")
    p.add_argument("--warmup", type=int, default=5, help="first steps left out of the statistics")
    p.add_argument("--dtypes", default="float32,bfloat16")
    p.add_argument("--dense", action="store_true", help="the smoke's dense-scene batch")
    args = p.parse_args(argv)
    if not 0 <= args.warmup < args.steps:
        p.error("--steps must exceed --warmup: the statistics need a step after the warm-up")
    phases = set(args.phases.split(","))
    if not phases <= {"rate", "stages", "profile"}:
        p.error(f"unknown phase in --phases {args.phases!r}")

    device = select_device()
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
            check=True,
        ).stdout.strip()
        print(card, flush=True)
        cs.extension()
    print(host_line(), flush=True)

    torch.backends.cudnn.benchmark = False
    cfg, labels = cs._train_setup(args.generation)
    print(f"generation {args.generation}{' dense' if args.dense else ''}", flush=True)
    gt = dict(max_gt=cs.DENSE_MAX_GT, boxes=cs.DENSE_BOXES) if args.dense else {}
    batch = cs._to_device(
        cs.synthetic_train_batch(tuple(args.canvas), cs.SEED + 4, labels=labels, **gt), device
    )
    model = cs._new_model(args.generation).to(device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    dtypes = [set_numerics(name) for name in args.dtypes.split(",")]
    if "rate" in phases:
        torch.backends.cudnn.deterministic = True
        for dtype in dtypes:
            run_rate(model, init, cfg, dtype, device, batch, args.steps, args.repeats, args.warmup)
    if "stages" in phases:
        # cuDNN's modes mean nothing on the CPU: split once there.
        modes = (True, False) if device.type == "cuda" else (True,)
        for dtype in dtypes:
            for deterministic in modes:
                run_stages(
                    model, init, cfg, dtype, device, batch, args.steps, args.warmup, deterministic
                )
    if "profile" in phases and device.type == "cuda":
        for dtype in dtypes:
            for deterministic in (True, False):
                torch.backends.cudnn.deterministic = deterministic
                run_profile(model, init, cfg, dtype, device, batch)
    print(host_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the PyTorch port's train step spends its time on one GPU.

Drives ``chip_smoke.py``'s full-width train configuration of either
generation (``--generation legacy``: VGG16, 21 classes, ``LEGACY_CONFIG``
budgets; ``--generation fpn``: ResNet50-FPN, 91 classes, raw COCO ids,
``FPN_CONFIG`` budgets; both with seeded random weights, the 800x1344
canvas, batch 2 and one repeated synthetic batch; ``--dense``: the smoke's
dense scene, gt padded to 512 slots (FPN: 640) with 300-500 boxes an
image, where the RoI targets' IoU runs through its kernel's match mode,
once a step)
and prints, per dtype (float32 with TF32 off, bfloat16 autocast):

1. rate: ``--repeats`` runs of 20 steps of ``make_train_step``
   from the same weights and generator seed, each step timed to a device
   sync as ``chip_smoke.py`` times it: img/s over the steps after the
   ``--warmup`` (5; steps 6 on, as the smoke counts them), step p50,
   and the number of NMS kernel launches (``ops/cuda/nms.cu``, one a step
   for the batch's proposals; 0 on the CPU, which runs the plain sweep) in
   those steps, with both per step;
2. stages: the same steps with a device sync between backbone + RPN
   forward, propose + targets, head + loss forward, backward and the SGD
   update, once with cuDNN deterministic (as the smoke runs) and once with
   its defaults (as the CLIs run; once only on the CPU): the median per
   stage over the steps after the warm-up;
3. busy share: ``torch.profiler`` over 3 whole steps, device kernel time
   (user annotations excluded) over wall time, the proposal NMS kernel's
   time and share of the step, and the top kernels.

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.engine.train import epoch_generator  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.ops import nms as nms_mod  # noqa: E402
from faster_rcnn_pytorch_tpu_torch.parallel.train_step import (  # noqa: E402
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


def _steady_summary(times, launches, batch_size, skip) -> str:
    t, s = times[skip:], launches[skip:]
    return (
        f"{batch_size * len(t) / sum(t):.2f} img/s over steps {skip + 1}-{len(times)} "
        f"(step p50 {1000 * statistics.median(t):.1f} ms, min {1000 * min(t):.1f}, "
        f"max {1000 * max(t):.1f}), NMS launches {sum(s)} (per step {min(s)}-{max(s)})"
    )


def run_rate(model, init, cfg, dtype, device, batch, steps, repeats, warmup) -> None:
    name = str(dtype).removeprefix("torch.")
    schedule = make_lr_schedule("constant", cs.TRAIN_LR, 1, steps)
    step_fn = make_train_step(cfg, schedule, autocast_dtype=None if dtype == torch.float32 else dtype)
    for r in range(repeats):
        model.load_state_dict(init)
        state = init_train_state(model, make_optimizer(model))
        gen = epoch_generator(cs.SEED, 0, device)
        times, launches, losses = [], [], []
        for _ in range(steps):
            nms_mod.nms_segments_cuda.launches = 0
            t0 = cs._sync(device)
            metrics = step_fn(state, batch, gen)
            times.append(cs._sync(device) - t0)
            launches.append(nms_mod.nms_segments_cuda.launches)
            losses.append(float(metrics["loss"]))
        print(
            f"rate {name} run {r + 1}/{repeats}: "
            f"{_steady_summary(times, launches, cs.TRAIN_BATCH, warmup)}, "
            f"loss step 1 {losses[0]:.4f} -> step {steps} {losses[-1]:.4f}",
            flush=True,
        )
        print(
            f"  per step ms: {' '.join(f'{1000 * t:.0f}' for t in times)}\n"
            f"  per step NMS launches: {' '.join(str(s) for s in launches)}",
            flush=True,
        )


def run_stages(model, init, cfg, dtype, device, batch, steps, warmup, deterministic: bool) -> None:
    torch.backends.cudnn.deterministic = deterministic
    name = str(dtype).removeprefix("torch.")
    model.load_state_dict(init)
    state = init_train_state(model, make_optimizer(model))
    rows, launches = cs.train_stage_rows(
        state, cfg, batch, dtype, steps, epoch_generator(cs.SEED, 0, device)
    )
    med = [1000 * statistics.median(r[i] for r in rows[warmup:]) for i in range(6)]
    nms = [n for n, _ in launches[warmup:]]
    print(
        f"stages {name} cudnn deterministic={deterministic}, ms per step (median of steps "
        f"{warmup + 1}-{steps}): {', '.join(f'{k} {v:.2f}' for k, v in zip(cs.TRAIN_STAGES, med))}, "
        f"total {med[5]:.2f}; NMS launches per step {min(nms)}-{max(nms)}; "
        f"IoU kernel launches {sum(i for _, i in launches)} in {steps} steps",
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
        t0 = cs._sync(device)
        for _ in range(3):
            step_fn(state, batch, gen)
        wall = cs._sync(device) - t0

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
    nms_us = sum(device_us(e) for e in kernels if "nms_segments_kernel" in e.key)
    print(
        f"  proposal NMS kernel {nms_us / 3000:.3f} ms/step, {nms_us / 1e6 / wall:.4f} of the step's wall time",
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
    gt = dict(max_gt=cs.dense_max_gt(args.generation), boxes=cs.DENSE_BOXES) if args.dense else {}
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

"""Cascade train cells: ``make_train_step``'s step of the cascade
configuration on a pool of host batches, each copied to the card as the
train loop copies it.

The contract is ``train.py``'s: set-up builds the one train state, drives
it through its first ``CHECK_STEPS`` (3) steps on three distinct batches
(the comparison's readings: the losses, the first update direction from
the optimizer's momentum, each leaf's change over the three), then
``WARMUP_STEPS`` (2) more; the window runs steps for ``--seconds`` and
ends in a synchronize, and ``train_img_s`` is every image it trained over
its whole time; ``setup_s`` is process start to the end of warm-up. A
traced run then profiles ``PROFILE_STEPS`` (5) more steps. After that
the program is freed and the plain reference, ``reference/cascade.py``,
follows the same three steps from the same weights (``lib/
cascade_weights.py``), the same batches and a generator seeded alike,
which it draws in the program's order: ``detector.draw_noise``'s four
tensors, then each later stage's positives and negatives.

Traffic parameters as ``train.py``'s: ``batch``, ``max_gt``, ``labels``
and ``box_counts``.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from benchmark.lib import cascade_weights, compare, device as dev, program, scenes
from benchmark.lib.calls import KernelCalls
from benchmark.lib.spans import ModuleSpans
from benchmark.lib.trace import Profiled, Record
from benchmark.reference.cascade import CascadeReference, stage_noise
from benchmark.reference.detector import anchor_count, draw_noise
from benchmark.roofline.flops import StepFlops
from benchmark.roofline.work import PEAKS, kernel_map
from benchmark.traffic.train import CHECK_STEPS, program_readings, seeds

WARMUP_STEPS = 2
PROFILE_STEPS = 5


def reference_readings(cell, host, seed: int, device, numerics="stated", rows=None) -> dict:
    """The plain reference's readings of the first ``CHECK_STEPS`` steps;
    ``rows`` keeps only those rows of each batch (the half-batch fault)."""
    conf = cell.config
    s = seeds(seed)
    w = cascade_weights.make(conf, s["weights"], device)
    ref = CascadeReference(conf["budgets"], w, device, numerics)
    gen = torch.Generator(device=device).manual_seed(s["noise"])
    opt, bud = conf["optimizer"], ref.bud
    out = {"losses": []}
    for step in range(CHECK_STEPS):
        batch = scenes.to_device(host[step], device)
        b, h, wd = batch["image"].shape[:3]
        g = batch["gt_boxes"].shape[1]
        noise = draw_noise(gen, b, anchor_count("fpn", h, wd), bud.post_nms_train + g, device)
        later = stage_noise(gen, b, bud.roi_samples + g, len(ref.stages.ious), device)
        noise = (*noise, *(t for pair in later for t in pair))
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
            noise = tuple(t[rows] for t in noise)
        losses, directions = ref.train_step(batch, noise, opt["lr"], opt["momentum"], opt["weight_decay"],
                                            getattr(torch, conf["dtype"]))
        out["losses"].append(float(losses[0]))
        if step == 0:
            params = ref.params()
            out["grad"] = {n: float(d.norm()) for n, d in directions.items()}
            out["raw_grad"] = {
                n: float((d - opt["weight_decay"] * (params[n].detach() + opt["lr"] * d)).norm())
                for n, d in directions.items()
            }
        del directions
    out["change"] = {n: float((p.detach() - w[n]).norm()) for n, p in ref.params().items()}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, start: float, fault=None) -> dict:
    conf, t = cell.config, cell.traffic
    s = seeds(seed)
    w = cascade_weights.make(conf, s["weights"], device)
    prog = program.Train(conf, w, device)  # first: a program without the cascade fails here, soon
    program.load_kernels(device)
    host = scenes.pool(t, conf["canvas"], s["scenes"], device)
    if fault is not None:
        fault(prog)
    gen = torch.Generator(device=device).manual_seed(s["noise"])
    flops = StepFlops(prog.model)
    readings = program_readings(prog, host, gen, device, w, flops)
    del w
    b = int(t["batch"])
    step = CHECK_STEPS
    for _ in range(WARMUP_STEPS):
        prog.step(scenes.to_device(host[step % len(host)], device), gen)
        step += 1
    dev.synchronize(device)
    setup_s = time.perf_counter() - start

    spans: dict = {}
    hooks = ModuleSpans(prog.model, conf["modules"], spans, ranges=False) if trace else contextlib.nullcontext()
    steps = 0
    with hooks:
        t0 = time.perf_counter()
        while True:
            batch = scenes.to_device(host[step % len(host)], device)
            td = time.perf_counter()
            prog.step(batch, gen)
            if trace:
                spans.setdefault("dispatch", []).append((time.perf_counter() - td) * 1e3)
            step += 1
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dev.synchronize(device)
        window = time.perf_counter() - t0
    img_s = steps * b / window

    record = None
    if trace:
        record = Record(
            kind="train", steps=PROFILE_STEPS, images_per_step=b, spans=spans,
            unprofiled_img_s=img_s, flops_per_image=flops.total / b, peak_flops=PEAKS["bf16_flops"],
            kernel_map=kernel_map(),
        )
        with Profiled(record), KernelCalls(record.calls), ModuleSpans(prog.model, conf["modules"], {}, True):
            with torch.profiler.record_function("bench.window"):
                for _ in range(record.steps):
                    with torch.profiler.record_function("bench.step"):
                        prog.step(scenes.to_device(host[step % len(host)], device), gen)
                    step += 1
                dev.synchronize(device)

    peak = dev.peak_bytes(device)
    del prog, flops, hooks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, host, seed, device)
    numbers = compare.train_numbers(readings, ref)
    correct, checks = compare.judge(numbers, cell.spec["limits"])
    return {
        "correct": correct,
        "attempted": steps,
        "failed": 0,
        "e2e": {"train_img_s": img_s, "setup_s": setup_s},
        "record": record,
        "device": dev.info(device, cell.chips, peak),
        "checks": checks,
    }

"""Predict cells: one caller in a closed loop, each call a host batch
copied to the card, ``predict`` on ``prepare_for_inference``'s model, and
the packed detections copied back to the host, as the eval loop does.

Set-up warms up ``WARMUP_CALLS`` calls of the cell's one shape. The
window issues calls for ``--seconds``: ``predict_img_s`` is every image
over the window's whole time and ``latency_p95_ms`` the 95th percentile
of every call's time from its start to its detections on the host. A
traced run then profiles ``PROFILE_CALLS`` more. After that the program
is freed and the plain reference predicts the pool batches of
``CHECK_CALLS`` calls drawn from the seed, to be matched with what those
calls returned.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.lib import compare, device as dev, program, scenes, weights
from benchmark.lib.calls import KernelCalls
from benchmark.lib.spans import StageRanges
from benchmark.lib.trace import Profiled, Range, Record
from benchmark.reference.detector import Budgets, Reference
from benchmark.roofline.flops import StepFlops
from benchmark.roofline.work import PEAKS, kernel_map

WARMUP_CALLS = 3
PROFILE_CALLS = 10
CHECK_CALLS = 4
STAGES = ("h2d", "backbone", "rpn_head", "propose", "roi_head", "decode", "class_nms")


def seeds(seed: int) -> dict:
    return {"weights": seed, "scenes": seed + 1, "sample": seed + 3}


def scales(conf: dict) -> dict:
    """The class head's weights scaled so that the seeded detector's class
    NMS sees a trained detector's load (the configuration's
    ``assumed.predict_cls_logit_scale``)."""
    factor = conf.get("assumed", {}).get("predict_cls_logit_scale", 1.0)
    return {f"{conf['modules']['roi_head']}.cls_head.weight": factor}


def unpack(packed: np.ndarray) -> list:
    """``[B, D, 7]`` packed detections -> per image ``(boxes, labels,
    scores)`` of its valid rows."""
    out = []
    for img in packed:
        v = img[:, 6] > 0.5
        out.append((img[v, :4], img[v, 4].astype(np.int64), img[v, 5]))
    return out


def reference_detections(cell, host, seed: int, device, indices, numerics="stated") -> dict:
    """``{pool index: per image (boxes, labels, scores)}`` of the plain
    reference, and its class NMS load (candidates and kept per image)."""
    conf = cell.config
    w = weights.make(conf, seeds(seed)["weights"], device, scales(conf))
    ref = Reference(conf["generation"], Budgets(**conf["budgets"]), w, device, numerics)
    del w
    out = {}
    for j in sorted(set(indices)):
        batch = scenes.to_device(host[j], device)
        dets = ref.predict(batch["image"], batch["extent"], getattr(torch, conf["dtype"]))
        out[j] = [tuple(t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                        for t in d) for d in dets]
    return out, ref.load


def run(cell, seed: int, seconds: float, trace: bool, device, start: float, fault=None) -> dict:
    conf, t = cell.config, cell.traffic
    s = seeds(seed)
    program.load_kernels(device)
    host = scenes.pool(t, conf["canvas"], s["scenes"], device, with_boxes=False)
    w = weights.make(conf, s["weights"], device, scales(conf))
    prog = program.Predict(conf, w, device)
    del w
    if fault is not None:
        fault(prog)
    b = int(t["batch"])

    def call(j, on_stage=None, spans=None):
        t0 = time.perf_counter()
        images = torch.from_numpy(np.ascontiguousarray(host[j]["image"])).to(device)
        extents = torch.from_numpy(host[j]["extent"].astype(np.float32)).to(device)
        td = time.perf_counter()
        det = prog.dispatch(images, extents, on_stage)
        if spans is not None:
            spans.setdefault("dispatch", []).append((time.perf_counter() - td) * 1e3)
        packed = prog.to_host(det)
        return packed, (time.perf_counter() - t0) * 1e3

    flops = StepFlops(prog.model)
    with flops:
        call(0)
    for i in range(1, WARMUP_CALLS):
        call(i % len(host))
    dev.synchronize(device)
    setup_s = time.perf_counter() - start

    spans: dict = {} if trace else None
    latency, outputs = [], []
    i = 0
    t0 = time.perf_counter()
    while True:
        j = i % len(host)
        packed, ms = call(j, spans=spans)
        latency.append(ms)
        outputs.append((j, packed))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    calls = i
    img_s = calls * b / window

    record = None
    if trace:
        record = Record(
            kind="predict", steps=PROFILE_CALLS, images_per_step=b, spans=spans,
            unprofiled_img_s=img_s, flops_per_image=flops.total / b, peak_flops=PEAKS["bf16_flops"],
            kernel_map=kernel_map(),
        )
        with Profiled(record), KernelCalls(record.calls):
            with torch.profiler.record_function("bench.window"):
                for _ in range(record.steps):
                    stages = StageRanges(STAGES)
                    call_range = Range("bench.call")
                    call_range.open()
                    stages.start()
                    packed, _ = call(i % len(host), stages)
                    call_range.close()
                    outputs.append((i % len(host), packed))
                    i += 1
                dev.synchronize(device)

    peak = dev.peak_bytes(device)
    del prog, flops
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rs = np.random.default_rng(s["sample"])
    sample = rs.choice(len(outputs), size=min(CHECK_CALLS, len(outputs)), replace=False)
    refs, load = reference_detections(cell, host, seed, device, [outputs[k][0] for k in sample])
    dev.note(f"class NMS load (reference): candidates a class-image pass the threshold, per image "
             f"median {np.median(load[0]):.0f} (min {min(load[0])}, max {max(load[0])}); "
             f"detections kept per image median {np.median(load[1]):.0f}")
    prog_imgs, ref_imgs = [], []
    for k in sample:
        j, packed = outputs[k]
        prog_imgs += unpack(packed)
        ref_imgs += refs[j]
    numbers = compare.predict_numbers(prog_imgs, ref_imgs)
    correct, checks = compare.judge(numbers, cell.spec["limits"])
    return {
        "correct": correct,
        "attempted": calls,
        "failed": 0,
        "e2e": {
            "predict_img_s": img_s,
            "latency_p95_ms": float(np.percentile(latency, 95)),
            "setup_s": setup_s,
        },
        "record": record,
        "device": dev.info(device, cell.chips, peak),
        "checks": checks,
    }

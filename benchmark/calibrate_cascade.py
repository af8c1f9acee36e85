"""Readings that the cascade cells' limits of ``correct`` are set from
(not part of a benchmark run): ``calibrate.py``'s train readings for the
traffic kind ``cascade_train``.

    python benchmark/calibrate_cascade.py --workload cascade_coco_train_b8 \
        --seeds 1 2 3 ... [--control-seeds 1 2 3] [--out cal.jsonl]

For each seed, in one process on the card: the program's sound readings
against the plain reference's (the lower readings). For each control
seed: the reference computed with float8 e4m3 products, and the fault of
half of each batch left out, each against the reference (the upper
readings). A state left unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition. Each line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.lib import cascade_weights, compare, device as dev, manifest, program, scenes  # noqa: E402
from benchmark.traffic import cascade_train as kind, train  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell, seed: int, device, control: bool) -> list:
    conf, t = cell.config, cell.traffic
    host = scenes.pool(t, conf["canvas"], train.seeds(seed)["scenes"], device)
    ref = kind.reference_readings(cell, host, seed, device)
    _free(device)
    s = train.seeds(seed)
    w = cascade_weights.make(conf, s["weights"], device)
    prog = program.Train(conf, w, device)
    gen = torch.Generator(device=device).manual_seed(s["noise"])
    got = train.program_readings(prog, host, gen, device, w)
    del prog, w
    _free(device)
    rows = [("program", compare.train_numbers(got, ref), got["losses"])]
    if control:
        fp8 = kind.reference_readings(cell, host, seed, device, numerics="fp8")
        _free(device)
        rows.append(("control_fp8", compare.train_numbers(fp8, ref), fp8["losses"]))
        half = list(range(int(t["batch"]) // 2))
        part = kind.reference_readings(cell, host, seed, device, rows=half)
        _free(device)
        rows.append(("fault_half_batch", compare.train_numbers(part, ref), part["losses"]))
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default="")
    args = p.parse_args()
    cell = manifest.cell(args.workload)
    dev.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    program.load_kernels(device)
    dev.note(dev.power_limit())
    sink = open(args.out, "a") if args.out else None
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        for what, numbers, extra in readings(cell, seed, device, seed in args.control_seeds):
            line = json.dumps({"cell": args.workload, "seed": seed, "what": what, "numbers": numbers,
                               "extra": extra, "s": time.perf_counter() - t0})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``correct`` are set from (not part of a
benchmark run).

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out chiprun_out/cal.jsonl]

For each seed, in one process on the card: the program's sound readings
against the plain reference's (the lower readings). For each control
seed: the control, the reference computed with float8 e4m3 products in
the program's place, and for train cells the fault of half of each batch
left out (the mean taken over the rest), each against the reference (the
upper readings). A state left unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition and needs no run. Each line printed
is one JSON object.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.lib import compare, device as dev, manifest, program, scenes, weights  # noqa: E402
from benchmark.traffic import predict as predict_kind, train as train_kind  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_program(cell, seed, device, host):
    s = train_kind.seeds(seed)
    w = weights.make(cell.config, s["weights"], device)
    prog = program.Train(cell.config, w, device)
    gen = torch.Generator(device=device).manual_seed(s["noise"])
    out = train_kind.program_readings(prog, host, gen, device, w)
    del prog, w
    _free(device)
    return out


def predict_program(cell, seed, device, host, indices):
    w = weights.make(cell.config, predict_kind.seeds(seed)["weights"], device, predict_kind.scales(cell.config))
    prog = program.Predict(cell.config, w, device)
    del w
    out = {}
    for j in sorted(set(indices)):
        images = torch.from_numpy(np.ascontiguousarray(host[j]["image"])).to(device)
        extents = torch.from_numpy(host[j]["extent"].astype(np.float32)).to(device)
        out[j] = predict_kind.unpack(prog.to_host(prog.dispatch(images, extents)))
    del prog
    _free(device)
    return out


def readings(cell, seed: int, device, control: bool) -> list:
    conf, t = cell.config, cell.traffic
    rows = []
    if t["kind"] == "train":
        host = scenes.pool(t, conf["canvas"], train_kind.seeds(seed)["scenes"], device)
        ref = train_kind.reference_readings(cell, host, seed, device)
        _free(device)
        prog = train_program(cell, seed, device, host)
        rows.append(("program", compare.train_numbers(prog, ref), prog["losses"]))
        if control:
            fp8 = train_kind.reference_readings(cell, host, seed, device, numerics="fp8")
            _free(device)
            rows.append(("control_fp8", compare.train_numbers(fp8, ref), fp8["losses"]))
            half = list(range(int(t["batch"]) // 2))
            part = train_kind.reference_readings(cell, host, seed, device, rows=half)
            _free(device)
            rows.append(("fault_half_batch", compare.train_numbers(part, ref), part["losses"]))
        return rows
    host = scenes.pool(t, conf["canvas"], predict_kind.seeds(seed)["scenes"], device, with_boxes=False)
    rs = np.random.default_rng(predict_kind.seeds(seed)["sample"])
    indices = rs.choice(len(host), size=predict_kind.CHECK_CALLS, replace=False).tolist()
    prog = predict_program(cell, seed, device, host, indices)
    ref, load = predict_kind.reference_detections(cell, host, seed, device, indices)
    _free(device)

    def flat(d):
        return [img for j in sorted(set(indices)) for img in d[j]]

    rows.append(("program", compare.predict_numbers(flat(prog), flat(ref)),
                 {"candidates": [int(x) for x in load[0]], "kept": [int(x) for x in load[1]]}))
    if control:
        fp8, _ = predict_kind.reference_detections(cell, host, seed, device, indices, numerics="fp8")
        _free(device)
        rows.append(("control_fp8", compare.predict_numbers(flat(fp8), flat(ref)), None))
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

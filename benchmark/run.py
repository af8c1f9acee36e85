"""Run one cell of the port's benchmark once and print its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``workloads/<cell>.json``; its configuration, traffic kind
and metrics are found by name (``README.md``). The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
``checks``: each compared number beside its limit, also the last lines of
standard error). Without the cards the cell asks for, or with JAX or the
JAX package loaded, it prints no result and exits non-zero.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a whole number >= 0")

    import torch

    from benchmark.lib import device, manifest, result

    cell = manifest.cell(args.workload)
    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        print(f"{args.workload}: {e}; no result", file=sys.stderr)
        return 2
    device.note(f"{args.workload}: {device.power_limit()}")
    kind = manifest.traffic_module(cell.traffic["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), START)
    return result.emit(cell, out, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())

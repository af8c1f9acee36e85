"""The run's last line, and the checks printed beside it."""

from __future__ import annotations

import json
import sys

from benchmark.lib.manifest import metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "faster_rcnn_pytorch_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(cell, record) -> dict:
    """Each of the cell's per-layer metrics that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def emit(cell, run: dict, trace: bool) -> int:
    """Print the checks to standard error and the result to standard
    output; 0, or 3 (no result) when JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"refusing to report: loaded {found}", file=sys.stderr, flush=True)
        return 3
    if trace:
        metrics = per_layer(cell, run["record"])
    else:
        metrics = {
            m["name"]: {"value": float(run["e2e"][m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end
        }
    out = {
        "correct": bool(run["correct"]),
        "attempted": int(run["attempted"]),
        "failed": int(run["failed"]),
        "metrics": metrics,
        "device": run["device"],
    }
    if trace:
        rec = run["record"]
        out["device"]["busy_s"] = rec.busy_s()
        out["device"]["window_s"] = rec.window_s
        out["breakdown"] = rec.breakdown()
    out["checks"] = run["checks"]
    for name, c in run["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

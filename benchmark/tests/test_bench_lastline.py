"""The run's last line: its keys, the checks last, the per-layer metrics
of a traced run, and no result without a card."""

import json
import os
import subprocess
import sys

from benchmark.lib import manifest, result
from benchmark.tests import small


def test_last_line_keys(capsys):
    c = small.cell("legacy_voc_train_b8")
    out = small.run(c)
    assert result.emit(c, out, trace=False) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(c.spec["limits"])
    assert captured.err.strip().splitlines()[-1].startswith("check " + list(c.spec["limits"])[-1])


def test_traced_line_reports_per_layer_metrics(capsys):
    c = small.cell("fpn_coco_predict_b8")
    out = small.run(c, trace=True)
    assert result.emit(c, out, trace=True) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert {"mfu.predict", "host_dispatch_ms.predict"} <= set(line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"), "--workload", "fpn_coco_predict_b8",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and '"correct"' not in proc.stdout

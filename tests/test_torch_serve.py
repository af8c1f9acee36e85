"""The port's HTTP inference server (``serve.py``) on the CPU.

* ``fit_scale``, ``pick_bucket``, ``preprocess`` and
  ``detections_to_pixels`` give exactly what the JAX package's ``serve.py``
  functions give on the same seeded inputs (host code copied, so equal);
* the ``MicroBatcher`` cases of ``tests/test_serve.py``: a full group, a
  deadline flush, wait 0, an error handed to every member;
* an HTTP round trip (``127.0.0.1``, port 0) over a CPU export dir of the
  tiny legacy detector (``tests/test_torch_legacy_predict.py``'s weights
  in a params sidecar, batch 2): concurrent ``/detect`` detections equal direct ``predict`` on
  the same canvases mapped to pixels, ``/metrics`` counts the requests and
  fewer dispatches than requests.
"""

import io
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu import serve as jserve
from faster_rcnn_pytorch_tpu_torch import serve as pserve
from faster_rcnn_pytorch_tpu_torch import serving
from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from tests.test_torch_legacy_predict import CANVAS_HW, models  # noqa: F401  (models: the fixture)

BUCKET4 = (4, (8, 8))


def test_host_functions_equal_jax_serve():
    rs = np.random.RandomState(0)
    buckets = [(1, (64, 96)), (1, (96, 64)), (2, (64, 96)), (4, (128, 128))]
    for _ in range(20):
        hw = (int(rs.randint(10, 300)), int(rs.randint(10, 300)))
        for _, canvas in buckets:
            assert pserve.fit_scale(hw, canvas) == jserve.fit_scale(hw, canvas)
        assert pserve.pick_bucket(hw, buckets) == jserve.pick_bucket(hw, buckets)
    for h, w in ((30, 60), (64, 96), (100, 41), (7, 300)):
        raw = rs.randint(0, 256, (h, w, 3), np.uint8)
        got, want = pserve.preprocess(raw, (64, 96)), jserve.preprocess(raw, (64, 96))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    row = rs.uniform(0, 1, (12, 7)).astype(np.float32)
    row[:, 4] = rs.randint(0, 20, 12)
    row[:, 6] = rs.uniform(size=12) > 0.3
    for thres in (None, 0.5):
        args = (row, (64, 96), 0.7, (80, 40), thres)
        assert pserve.detections_to_pixels(*args) == jserve.detections_to_pixels(*args)
    with pytest.raises(ValueError):
        pserve.pick_bucket((10, 10), [])


def _echo_dispatch(calls, delay=0.0):
    def dispatch(bucket, images, extents):
        calls.append(images.shape[0])
        if delay:
            time.sleep(delay)
        return np.concatenate([extents, images.reshape(images.shape[0], -1)[:, :1]], axis=1)

    return dispatch


def _run_threads(mb, n, results):
    def worker(i):
        canvas = np.full((8, 8, 3), float(i), np.float32)
        extent = np.array([i, i + 0.5], np.float32)
        try:
            results[i] = mb.run(BUCKET4, canvas, extent)
        except Exception as e:  # noqa: BLE001 (collected for assertions)
            results[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)


def test_micro_batcher_groups_full_batch():
    calls: list[int] = []
    mb = pserve.MicroBatcher(_echo_dispatch(calls), wait_s=5.0)
    results: dict = {}
    _run_threads(mb, 4, results)
    assert calls == [4]
    for i in range(4):
        row, n = results[i]
        assert n == 4
        np.testing.assert_allclose(row[:2], [i, i + 0.5])
        assert row[2] == float(i)


def test_micro_batcher_deadline_flushes_partial_group():
    calls: list[int] = []
    mb = pserve.MicroBatcher(_echo_dispatch(calls), wait_s=0.05)
    results: dict = {}
    _run_threads(mb, 2, results)
    sizes = sorted(results[i][1] for i in range(2))
    assert len(calls) == {(1, 1): 2, (2, 2): 1}[tuple(sizes)]
    for i in range(2):
        np.testing.assert_allclose(results[i][0][:2], [i, i + 0.5])


def test_micro_batcher_wait_zero_dispatches_immediately():
    calls: list[int] = []
    mb = pserve.MicroBatcher(_echo_dispatch(calls), wait_s=0.0)
    row, n = mb.run(BUCKET4, np.zeros((8, 8, 3), np.float32), np.array([0.7, 0.9], np.float32))
    assert calls == [4] and n == 1
    np.testing.assert_allclose(row[:2], [0.7, 0.9])


def test_micro_batcher_propagates_dispatch_error_to_all():
    def boom(bucket, images, extents):
        raise ValueError("device fell over")

    mb = pserve.MicroBatcher(boom, wait_s=0.05)
    results: dict = {}
    _run_threads(mb, 3, results)
    for i in range(3):
        assert isinstance(results[i], ValueError)


def jpeg_bytes(h, w, seed=0):
    from PIL import Image

    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 255, (h, w, 3), np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def export_dir(models, tmp_path_factory):  # noqa: F811
    _, _, _, pmodel, pcfg = models
    out = str(tmp_path_factory.mktemp("export"))
    entries = []
    for canvas in (CANVAS_HW, CANVAS_HW[::-1]):
        ep = serving.export_predict(pmodel, pcfg, canvas, 2, 0.05, params_as_args=True)
        name = serving.artifact_name(canvas, 2)
        serving.save_artifact(ep, os.path.join(out, name))
        entries.append(
            {"file": name, "canvas_hw": list(canvas), "batch": 2, "platforms": ["cpu"], "params_as_args": True}
        )
    serving.save_params_sidecar(pmodel, os.path.join(out, serving.PARAMS_SIDECAR))
    extra = {
        "data_type": "voc", "model_generation": "legacy", "num_classes": 6,
        "params_file": serving.PARAMS_SIDECAR,
    }
    serving.write_manifest(out, entries, extra=extra)
    yield out
    shutil.rmtree(out, ignore_errors=True)  # a 0.5 GB weights file


def test_http_round_trip_equals_direct_predict(models, export_dir):  # noqa: F811
    _, _, _, pmodel, pcfg = models
    # the leader waits only until its group is full: a long wait costs nothing here
    server = pserve.InferenceServer(export_dir, batch_wait_ms=10000, device="cpu")
    httpd = pserve.make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    sizes = [(50, 90), (40, 80)]  # landscape: both in the 64x96 bucket
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["buckets"] == [[2, 64, 96], [2, 96, 64]]
        outs: dict = {}

        def fire(i):
            req = urllib.request.Request(
                f"{base}/detect", data=jpeg_bytes(*sizes[i], seed=i), method="POST"
            )
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = json.load(r)

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                urllib.request.Request(f"{base}/detect", data=b"junk", method="POST"), timeout=60
            )
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()

    assert metrics["requests"] == 2 and metrics["errors"] == 1
    assert metrics["dispatches"] == 1 and metrics["batch_hist"] == {"2": 2}
    # the same canvases through direct predict, in either slot order (the
    # batcher fills slots in arrival order)
    raws = [pserve.decode_image_bytes(jpeg_bytes(*sizes[i], seed=i)) for i in range(2)]
    prepped = [pserve.preprocess(raw, CANVAS_HW) for raw in raws]
    images = torch.tensor(np.stack([p[0] for p in prepped]))
    extents = torch.tensor(np.stack([p[1] for p in prepped]))
    got = {
        i: [{k: d[k] for k in ("box", "label", "score")} for d in outs[i]["detections"]]
        for i in range(2)
    }
    for perm in ([0, 1], [1, 0]):
        packed = serving.pack_detections(
            pfr.predict(pmodel, pcfg, images[perm], extents[perm], 0.05)
        ).numpy()
        want = {
            i: pserve.detections_to_pixels(packed[slot], CANVAS_HW, prepped[i][2], sizes[i][::-1], None)
            for slot, i in enumerate(perm)
        }
        if got == want:
            break
    assert got == want
    assert all(outs[i]["batched"] == 2 and outs[i]["bucket"] == [2, 64, 96] for i in range(2))
    assert sum(len(outs[i]["detections"]) for i in range(2)) > 0


def test_serve_cli_on_the_cpu(export_dir):
    """``python -m faster_rcnn_pytorch_tpu_torch.serve`` under
    ``FRT_TORCH_DEVICE=cpu``: it warms every bucket, then answers
    ``/healthz`` and ``/info`` with the export dir's buckets and manifest."""
    import socket
    import subprocess
    import sys

    from tests.torch_threads import subprocess_env

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "faster_rcnn_pytorch_tpu_torch.serve", "--export_dir", export_dir,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=repo, env=subprocess_env(FRT_TORCH_DEVICE="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        health = None
        while health is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                    health = json.load(r)
            except OSError:
                time.sleep(0.5)
        assert health == {"status": "ok", "buckets": [[2, 64, 96], [2, 96, 64]]}, proc.poll()
        with urllib.request.urlopen(f"{base}/info", timeout=30) as r:
            info = json.load(r)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            assert info == json.load(f)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    assert "warming 2 bucket(s)" in out and f"on http://127.0.0.1:{port}" in out

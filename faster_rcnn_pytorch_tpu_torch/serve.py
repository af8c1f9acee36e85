"""HTTP inference server over the port's exported serving artifacts
(counterpart of ``faster_rcnn_pytorch_tpu/serve.py``, whose host logic it
copies).

It serves the :mod:`serving` ``torch.export`` artifacts of one device
(``utils.runtime.select_device``: the card, or the CPU under
``FRT_TORCH_DEVICE=cpu``) behind a minimal, dependency-free HTTP API
(stdlib ``http.server``, threaded):

    frcnn-torch-serve --export_dir ./export --port 8000

Endpoints:

  GET  ``/healthz`` — liveness + available (batch, canvas) buckets.
  GET  ``/info``    — the export manifest (calling convention, classes).
  GET  ``/metrics`` — serving counters: requests/errors/detections,
        request-latency percentiles (p50/p90/p99 over a sliding window),
        dispatch count and micro-batch group-size histogram, uptime.
  POST ``/detect``  — raw image bytes (JPEG/PNG/anything PIL decodes) in
        the request body. Response JSON::

            {"detections": [{"box": [x1, y1, x2, y2],   # original pixels
                             "label": 3, "name": "cat", "score": 0.93}],
             "image_wh": [w, h], "bucket": [batch, ch, cw],
             "time_ms": 12.4}

        Query parameter ``?thres=0.6`` raises the score cutoff at
        request time (the threshold baked into the artifact is the
        floor: an exported program cannot lower it per request).

Each request is routed to the exported (batch, canvas) bucket that the
aspect-preserving resize fills best, exactly the eval contract
(min-side/max-side resize into a padded canvas with an extent mask);
detections come back in canvas-[0,1] coordinates and are mapped to
original pixel space here on the host. Device work is serialized with a
lock: one card, one program at a time (concurrency above that belongs
to a replica fleet, not this process); a dispatch moves the batch to the
device, runs the bucket's program and copies the packed ``[B, D, 7]``
back in one transfer.

``--batch_wait_ms N`` turns on request micro-batching: an exported
(batch B, canvas) artifact always runs B slots of compute, so a lone
request wastes B-1 of them. With batching, the first request into an
idle bucket waits up to N ms for concurrent same-bucket requests (or
until the batch is full) and the group shares ONE device dispatch —
under load this multiplies throughput by up to B for the price of N ms
of added tail latency. Off by default (N=0: dispatch immediately).
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

import torch

from faster_rcnn_pytorch_tpu_torch.data.transforms import normalize
from faster_rcnn_pytorch_tpu_torch.serving import ExportedDetector
from faster_rcnn_pytorch_tpu_torch.utils.label_info import class_names


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 HWC RGB (PIL handles format sniffing)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def fit_scale(image_hw: tuple[int, int], canvas_hw: tuple[int, int]) -> float:
    """Aspect-preserving scale that fits ``image_hw`` inside the canvas.

    Upscaling is intentional when the image is smaller than the canvas —
    the eval pipeline's min-side-800 resize upscales small images the
    same way (datasets/transforms_.py:61-127 semantics).
    """
    h, w = image_hw
    ch, cw = canvas_hw
    return min(ch / h, cw / w)


def pick_bucket(
    image_hw: tuple[int, int], buckets: list[tuple[int, tuple[int, int]]]
) -> tuple[int, tuple[int, int]]:
    """Choose the (batch, canvas) bucket the resized image fills best.

    Fill ratio = resized area / canvas area; orientation-matched buckets
    win naturally (a landscape image fills the landscape canvas). Ties
    prefer the smallest batch (least padded compute per request).
    """
    if not buckets:
        raise ValueError("export manifest lists no artifacts")
    h, w = image_hw

    def fill(entry):
        b, (ch, cw) = entry
        s = fit_scale((h, w), (ch, cw))
        return (round(h * s) * round(w * s)) / (ch * cw)

    return max(buckets, key=lambda e: (fill(e), -e[0]))


def preprocess(
    raw: np.ndarray, canvas_hw: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, float]:
    """uint8 RGB -> (normalized canvas [ch,cw,3] f32, extent [2] f32, scale).

    Same contract the training/eval loader produces: ImageNet-normalized
    pixels in the top-left, zeros elsewhere, extent = valid (w, h)
    fraction.
    """
    ch, cw = canvas_hw
    h, w = raw.shape[:2]
    s = fit_scale((h, w), (ch, cw))
    nh = min(ch, max(1, round(h * s)))
    nw = min(cw, max(1, round(w * s)))
    if (nh, nw) != (h, w):
        from PIL import Image

        raw = np.asarray(
            Image.fromarray(raw).resize((nw, nh), Image.BILINEAR)
        )
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:nh, :nw] = normalize(raw)
    extent = np.array([nw / cw, nh / ch], np.float32)
    return canvas, extent, s


def detections_to_pixels(
    row: np.ndarray,
    canvas_hw: tuple[int, int],
    scale: float,
    image_wh: tuple[int, int],
    thres: float | None,
) -> list[dict]:
    """One packed [D, 7] row -> JSON-ready detections in original pixels."""
    ch, cw = canvas_hw
    w, h = image_wh
    keep = row[:, 6] > 0.5
    if thres is not None:
        keep &= row[:, 5] >= thres
    out = []
    for x1, y1, x2, y2, label, score, _ in row[keep]:
        box = [
            float(np.clip(x1 * cw / scale, 0, w)),
            float(np.clip(y1 * ch / scale, 0, h)),
            float(np.clip(x2 * cw / scale, 0, w)),
            float(np.clip(y2 * ch / scale, 0, h)),
        ]
        out.append({"box": box, "label": int(label), "score": float(score)})
    return out


class ServerStats:
    """Thread-safe serving counters for the ``/metrics`` endpoint.

    Latencies live in a bounded sliding window (last ``window`` request
    durations) so percentiles track current behavior instead of the
    process lifetime; counters are monotonic.
    """

    def __init__(self, window: int = 1024):
        self._mu = threading.Lock()
        self._t0 = time.monotonic()
        self._lat = collections.deque(maxlen=window)
        self.requests = 0
        self.errors = 0
        self.detections = 0
        self.dispatches = 0
        self.batch_hist: dict[int, int] = {}

    def record_request(self, ms: float, n_detections: int, group_n: int):
        with self._mu:
            self.requests += 1
            self.detections += n_detections
            self._lat.append(ms)
            # group leaders account for the dispatch; followers only for
            # the histogram-by-observation (one entry per request keeps
            # the histogram interpretable as "requests by group size")
            self.batch_hist[group_n] = self.batch_hist.get(group_n, 0) + 1

    def record_dispatch(self):
        with self._mu:
            self.dispatches += 1

    def record_error(self):
        with self._mu:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._mu:
            lat = sorted(self._lat)
            q = (
                lambda p: round(lat[min(len(lat) - 1, int(p * len(lat)))], 2)
                if lat
                else None
            )
            return {
                "uptime_s": round(time.monotonic() - self._t0, 1),
                "requests": self.requests,
                "errors": self.errors,
                "detections": self.detections,
                "dispatches": self.dispatches,
                "batch_hist": {str(k): v for k, v in sorted(self.batch_hist.items())},
                "latency_ms": {
                    "window": len(lat),
                    "p50": q(0.50),
                    "p90": q(0.90),
                    "p99": q(0.99),
                },
            }


class _Group:
    """One micro-batch in flight: its pending items and a closed flag
    (set when the leader snapshots the group for dispatch)."""

    __slots__ = ("items", "closed")

    def __init__(self):
        self.items: list[dict] = []
        self.closed = False


class MicroBatcher:
    """Group concurrent same-bucket requests into one device dispatch.

    The first request into an idle bucket becomes the group *leader*:
    it waits up to ``wait_s`` for followers (or until the bucket's
    batch is full), packs the group into one ``[B, ...]`` call, runs
    ``dispatch`` once, and hands each member its row. Followers block
    on an event the leader always sets (dispatch errors propagate to
    every member). ``wait_s=0`` dispatches immediately — the unbatched
    behavior, minus nothing.
    """

    def __init__(self, dispatch, wait_s: float = 0.0):
        self._dispatch = dispatch  # (bucket, images, extents) -> [B,D,7]
        self._wait = wait_s
        self._cv = threading.Condition()
        self._groups: dict = {}  # bucket -> _Group

    def run(self, bucket, canvas: np.ndarray, extent: np.ndarray):
        """Submit one request; returns ``(packed_row, group_size)``."""
        batch = bucket[0]
        item = {"canvas": canvas, "extent": extent, "result": None,
                "error": None, "n": 0, "done": threading.Event()}
        with self._cv:
            g = self._groups.get(bucket)
            if g is None or g.closed or len(g.items) >= batch:
                g = _Group()
                self._groups[bucket] = g
            g.items.append(item)
            leader = len(g.items) == 1
            if not leader:
                self._cv.notify_all()  # wake a leader waiting for fullness
        if not leader:
            # The leader sets the event in a finally; the timeout is a
            # backstop against a leader thread dying uncleanly.
            if not item["done"].wait(timeout=600.0):
                raise RuntimeError("micro-batch leader never dispatched")
            if item["error"] is not None:
                raise item["error"]
            return item["result"], item["n"]

        if self._wait > 0 and batch > 1:
            deadline = time.monotonic() + self._wait
            with self._cv:
                while len(g.items) < batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
        with self._cv:
            g.closed = True
            if self._groups.get(bucket) is g:
                del self._groups[bucket]
            items = list(g.items)
        try:
            images = np.zeros((batch,) + items[0]["canvas"].shape, np.float32)
            extents = np.ones((batch, 2), np.float32)
            for i, it in enumerate(items):
                images[i] = it["canvas"]
                extents[i] = it["extent"]
            packed = self._dispatch(bucket, images, extents)
            for i, it in enumerate(items):
                it["result"] = packed[i]
                it["n"] = len(items)
        except BaseException as e:  # propagate to every member — plain
            # Exception would let a KeyboardInterrupt/SystemExit in the
            # leader release followers with result=None, error=None
            for it in items:
                it["error"] = e
        finally:
            for it in items:
                it["done"].set()
        if item["error"] is not None:
            raise item["error"]
        return item["result"], item["n"]


class InferenceServer:
    """Request -> bucket routing -> artifact call -> pixel-space JSON."""

    def __init__(
        self,
        export_dir: str,
        default_thres: float | None = None,
        batch_wait_ms: float = 0.0,
        device=None,
    ):
        if device is None:
            from faster_rcnn_pytorch_tpu_torch.utils.runtime import select_device

            device = select_device()
        self.device = torch.device(device)
        self.detector = ExportedDetector(export_dir, self.device.type)
        self.default_thres = default_thres
        m = self.detector.manifest
        self.names = class_names(
            m.get("data_type", "voc"), m.get("model_generation", "legacy")
        )
        self._lock = threading.Lock()
        self._batcher = MicroBatcher(
            self._dispatch, wait_s=batch_wait_ms / 1e3
        )
        self.stats = ServerStats()

    def _dispatch(self, bucket, images: np.ndarray, extents: np.ndarray):
        with self._lock:  # one card, one program at a time
            out = self.detector(
                torch.from_numpy(images).to(self.device), torch.from_numpy(extents).to(self.device)
            ).cpu().numpy()
        self.stats.record_dispatch()
        return out

    def detect(self, data: bytes, thres: float | None = None) -> dict:
        t0 = time.perf_counter()
        raw = decode_image_bytes(data)
        h, w = raw.shape[:2]
        batch, canvas_hw = pick_bucket((h, w), self.detector.buckets())
        canvas, extent, scale = preprocess(raw, canvas_hw)
        row, group_n = self._batcher.run((batch, canvas_hw), canvas, extent)
        if thres is None:
            thres = self.default_thres
        dets = detections_to_pixels(row, canvas_hw, scale, (w, h), thres)
        for d in dets:
            d["name"] = (
                self.names[d["label"]]
                if 0 <= d["label"] < len(self.names)
                else str(d["label"])
            )
        ms = round((time.perf_counter() - t0) * 1e3, 2)
        self.stats.record_request(ms, len(dets), group_n)
        return {
            "detections": dets,
            "image_wh": [w, h],
            "bucket": [batch, canvas_hw[0], canvas_hw[1]],
            "batched": group_n,
            "time_ms": ms,
        }

    def warmup(self) -> None:
        """Run one dummy request per bucket so artifact load + first
        dispatch happen before the port accepts traffic."""
        for batch, (ch, cw) in self.detector.buckets():
            images = torch.zeros((batch, ch, cw, 3), device=self.device)
            extents = torch.ones((batch, 2), device=self.device)
            self.detector(images, extents).cpu()


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send_json(self, obj, status: int = 200) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(
                    {
                        "status": "ok",
                        "buckets": [
                            [b, h, w]
                            for b, (h, w) in server.detector.buckets()
                        ],
                    }
                )
            elif path == "/info":
                self._send_json(server.detector.manifest)
            elif path == "/metrics":
                self._send_json(server.stats.snapshot())
            else:
                self._send_json({"error": f"no route {path}"}, 404)

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/detect":
                self._send_json({"error": f"no route {url.path}"}, 404)
                return
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                self._send_json({"error": "empty body"}, 400)
                return
            data = self.rfile.read(length)
            q = parse_qs(url.query)
            try:
                thres = float(q["thres"][0]) if "thres" in q else None
            except ValueError:
                self._send_json({"error": "bad thres"}, 400)
                return
            try:
                self._send_json(server.detect(data, thres))
            except Exception as e:  # decode/shape errors -> client fault
                server.stats.record_error()
                self._send_json({"error": str(e)}, 400)

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}")

    return Handler


def make_http_server(
    server: InferenceServer, host: str = "0.0.0.0", port: int = 8000
) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), _make_handler(server))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--export_dir", required=True,
                    help="directory written by frcnn-torch-export")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--thres", type=float, default=None,
                    help="default score cutoff applied on top of the "
                    "artifact's baked threshold")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip per-bucket warmup before binding the port")
    ap.add_argument("--batch_wait_ms", type=float, default=0.0,
                    help="micro-batching: hold the first request into an "
                    "idle bucket up to this long for concurrent same-"
                    "bucket requests to share one device dispatch "
                    "(0 = dispatch immediately)")
    args = ap.parse_args(argv)

    server = InferenceServer(
        args.export_dir,
        default_thres=args.thres,
        batch_wait_ms=args.batch_wait_ms,
    )
    if not args.no_warmup:
        print(f"warming {len(server.detector.buckets())} bucket(s)...")
        server.warmup()
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving {args.export_dir} on http://{args.host}:{args.port} "
          f"(buckets: {server.detector.buckets()})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched HTTP inference server: the JAX ``serve.py`` on the port's
pipelines.

    python -m stroke_derenderer_tpu_torch.serve --models models_demo \
        --port 8700 [--device cuda|cpu] [--decode greedy|beam]

Endpoints (PNG body in, JSON out):
  POST /binarize  -> {"binarized_png_b64": ..., "height": H, "width": W}
  POST /derender  -> {"strokes": [[X, Y], ...], "binarize_s": ..., ...}
                     (?svg=1 adds "svg": the strokes as an SVG document in
                      the input image's coordinates)
  GET  /healthz   -> {"ok": true}
  GET  /metrics   -> requests and errors by endpoint, the batch size
                     histogram, per-stage latency quantiles (a batch's
                     binarize and strokes calls, each request's wait in
                     the queue until its batch started) and uptime, as
                     JSON or, with ?format=prom, as Prometheus text

A body that is not a PNG gets 400, an unknown path 404, a batch that
failed 500 (to each of its requests), a request not answered within the
timeout 504. Requests that arrive within ``--batch-window-ms`` of each
other run as one batch: one ``binarize_images`` call over all their images
and one ``process_images`` call over the masks of the ``/derender`` ones,
so that the decode kernel launches once per batch. The server runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from stroke_derenderer_tpu_torch.cli import initialize_sessions
from stroke_derenderer_tpu_torch.io import (
    decode_png, encode_png, strokes_to_svg, to_rgb,
)
from stroke_derenderer_tpu_torch.ops.strokes import strokes_to_json

log = logging.getLogger(__name__)


class Metrics:
    """Serving counters, guarded by one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.t_start = time.time()
        self.requests: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.batches = 0
        self.batch_hist: dict[int, int] = {}   # batch size -> count
        self.lat: dict[str, list[float]] = {"binarize": [], "strokes": [],
                                            "queue": []}

    def count(self, endpoint: str, error: bool = False):
        with self._lock:
            self.requests[endpoint] = self.requests.get(endpoint, 0) + 1
            if error:
                self.errors[endpoint] = self.errors.get(endpoint, 0) + 1

    def batch(self, n: int, t_bin: float, t_se: float | None,
              waits=()):
        """One batch of ``n`` requests: its binarize and strokes seconds
        (None: no strokes asked) and each request's seconds in the queue
        until the batch started."""
        with self._lock:
            self.batches += 1
            self.batch_hist[n] = self.batch_hist.get(n, 0) + 1
            self.lat["binarize"].append(t_bin)
            if t_se is not None:
                self.lat["strokes"].append(t_se)
            self.lat["queue"].extend(waits)
            for k in self.lat:  # bounded memory: keep the last 1024
                if len(self.lat[k]) > 1024:
                    del self.lat[k][:-1024]

    def snapshot(self) -> dict:
        def q(xs, p):
            return round(float(np.quantile(xs, p)), 4) if xs else None

        with self._lock:
            return {
                "uptime_s": round(time.time() - self.t_start, 1),
                "requests": dict(self.requests),
                "errors": dict(self.errors),
                "batches": self.batches,
                "batch_size_hist": {str(k): v for k, v
                                    in sorted(self.batch_hist.items())},
                "latency_s": {
                    stage: {"p50": q(xs, 0.5), "p90": q(xs, 0.9),
                            "p99": q(xs, 0.99), "n": len(xs)}
                    for stage, xs in self.lat.items()
                },
            }

    def prometheus(self) -> str:
        s = self.snapshot()
        lines = [f"sd_uptime_seconds {s['uptime_s']}",
                 f"sd_batches_total {s['batches']}"]
        for ep, n in s["requests"].items():
            lines.append(f'sd_requests_total{{endpoint="{ep}"}} {n}')
        for ep, n in s["errors"].items():
            lines.append(f'sd_errors_total{{endpoint="{ep}"}} {n}')
        for size, n in s["batch_size_hist"].items():
            lines.append(f'sd_batch_size_total{{size="{size}"}} {n}')
        for stage, qs in s["latency_s"].items():
            for p in ("p50", "p90", "p99"):
                if qs[p] is not None:
                    lines.append(
                        f'sd_stage_latency_seconds{{stage="{stage}",'
                        f'quantile="{p}"}} {qs[p]}')
        return "\n".join(lines) + "\n"


class _Job:
    def __init__(self, img: np.ndarray, want_strokes: bool,
                 want_svg: bool = False):
        self.img = img
        self.want_strokes = want_strokes
        self.want_svg = want_svg
        self.done = threading.Event()
        self.result: dict | None = None
        self.error: str | None = None
        self.t_queued: float | None = None  # time.monotonic() at submit


class BatchWorker(threading.Thread):
    """Collects jobs for up to ``window_s`` after the first one (at most
    ``max_batch``) and runs them as one batch; :meth:`close` ends the
    thread after the batch in hand."""

    def __init__(self, binarizer, estimator, window_s: float = 0.01,
                 max_batch: int = 64, metrics: Metrics | None = None):
        super().__init__(daemon=True)
        self.binarizer = binarizer
        self.estimator = estimator
        self.window_s = window_s
        self.max_batch = max_batch
        self.metrics = metrics or Metrics()
        self.q: queue.Queue[_Job | None] = queue.Queue()

    def submit(self, job: _Job):
        job.t_queued = time.monotonic()
        self.q.put(job)

    def close(self):
        self.q.put(None)

    def run(self):
        # Inference mode is per thread: the pipelines run on this one.
        with torch.inference_mode():
            while True:
                job = self.q.get()
                if job is None:
                    return
                jobs = [job]
                deadline = time.time() + self.window_s
                while len(jobs) < self.max_batch:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        break
                    try:
                        job = self.q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if job is None:
                        self._process(jobs)
                        return
                    jobs.append(job)
                self._process(jobs)

    def _process(self, jobs):
        t_start = time.monotonic()
        waits = [t_start - j.t_queued for j in jobs if j.t_queued is not None]
        try:
            t0 = time.time()
            bins = self.binarizer.binarize_images([j.img for j in jobs])
            t_bin = time.time() - t0
            masks = [b[:, :, 0] > (255 * self.binarizer.config.bin_thr)
                     for b in bins]
            stroke_jobs = [(i, m) for i, (j, m) in enumerate(zip(jobs, masks))
                           if j.want_strokes]
            stroke_results = {}
            t_se = 0.0
            if stroke_jobs:
                t0 = time.time()
                lists = self.estimator.process_images(
                    [m for _, m in stroke_jobs])
                t_se = time.time() - t0
                for (i, _), s in zip(stroke_jobs, lists):
                    stroke_results[i] = s
            self.metrics.batch(len(jobs), t_bin,
                               t_se if stroke_jobs else None, waits)
            for i, (job, mask) in enumerate(zip(jobs, masks)):
                out = {
                    "height": int(job.img.shape[0]),
                    "width": int(job.img.shape[1]),
                    "binarize_s": round(t_bin / len(jobs), 4),
                    "batch_size": len(jobs),
                    "binarized_png_b64": base64.b64encode(encode_png(
                        (mask * 255).astype(np.uint8))).decode(),
                }
                if job.want_strokes:
                    ratio = job.img.shape[0] / mask.shape[0]
                    out["strokes"] = strokes_to_json(stroke_results[i],
                                                     scale=ratio)
                    out["strokes_s"] = round(t_se / len(stroke_jobs), 4)
                    if job.want_svg:
                        out["svg"] = strokes_to_svg(
                            stroke_results[i], scale=ratio,
                            size=(job.img.shape[1], job.img.shape[0]))
                job.result = out
                job.done.set()
        except Exception as exc:  # noqa: BLE001 - reported to each waiter
            log.exception("batch of %d failed", len(jobs))
            for job in jobs:
                job.error = f"{type(exc).__name__}: {exc}"
                job.done.set()


def make_handler(worker: BatchWorker, timeout_s: float = 120.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.info("%s " + fmt, self.client_address[0], *args)

        def _send(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                self._reply(200, {"ok": True})
            elif path == "/metrics":
                if "format=prom" in query.split("&"):
                    self._send(200, worker.metrics.prometheus().encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._reply(200, worker.metrics.snapshot())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path not in ("/binarize", "/derender"):
                worker.metrics.count(path, error=True)
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = to_rgb(decode_png(self.rfile.read(n)))
            except ValueError as exc:  # bad input is the client's error
                worker.metrics.count(path, error=True)
                self._reply(400, {"error": f"bad image: {exc}"})
                return
            job = _Job(img, want_strokes=path == "/derender",
                       want_svg="svg=1" in query.split("&"))
            worker.submit(job)
            if not job.done.wait(timeout_s):
                worker.metrics.count(path, error=True)
                self._reply(504, {"error": "timeout"})
                return
            if job.error:
                worker.metrics.count(path, error=True)
                self._reply(500, {"error": job.error})
            else:
                worker.metrics.count(path)
                self._reply(200, job.result)

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Handwriting derenderer HTTP server (PyTorch / CUDA)")
    ap.add_argument("--models", required=True,
                    help="Folder holding the model files.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    ap.add_argument("--batch-window-ms", type=float, default=10.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--decode", choices=["greedy", "beam"], default=None)
    ap.add_argument("--beam-size", type=int, default=None)
    ap.add_argument("--device-partition", action="store_true",
                    help="Crops built on the device (the port's only mode).")
    ap.add_argument("--quant", choices=["none", "int8"], default=None,
                    help="int8: dynamic int8 UNet and encoder conv stacks "
                         "(ops/quant.py). Under int8 a request's result "
                         "depends on the requests batched beside it.")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ov, bov = {}, {}
    if args.decode:
        ov["decode"] = args.decode
    if args.beam_size:
        ov["beam_size"] = args.beam_size
    if args.quant:
        ov["quant"] = bov["quant"] = args.quant
    binarizer, estimator = initialize_sessions(
        args.models, device=args.device, se_overrides=ov or None,
        bin_overrides=bov or None)
    worker = BatchWorker(binarizer, estimator,
                         window_s=args.batch_window_ms / 1000.0,
                         max_batch=args.max_batch)
    worker.start()
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(worker))
    log.info("serving on http://%s:%d (models=%s, device=%s)", args.host,
             server.server_port, args.models, binarizer.device)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        worker.close()


if __name__ == "__main__":
    main()

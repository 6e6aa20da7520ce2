"""The port's HTTP server on the CPU: real round trips against a live server
thread, as ``tests/test_serve.py`` does for the JAX package, on a tiny
float32 strokes model and the shipped binarizer in float32; the strokes it
serves against ``process_images``; its failure replies; and
``serve.main``'s device policy."""

import base64
import http.client
import json
import shutil
import sys
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch import cli, serve
from stroke_derenderer_tpu_torch.io import decode_png, encode_png
from stroke_derenderer_tpu_torch.ops.strokes import strokes_to_json

REPO = Path(__file__).resolve().parent.parent
TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=24,
                        compute_dtype="float32")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A tiny strokes model and the shipped binarizer: a random binarizer
    marks most of a line as ink, which leaves one glyph and no strokes."""
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    for name in ("binarizer.msgpack", "configs_binarizer.json"):
        shutil.copy(REPO / "models_demo" / name, d / name)
    return d


@pytest.fixture(scope="module")
def sessions(models):
    return cli.initialize_sessions(models, device="cpu", bin_overrides={
        "compute_dtype": "float32"})


def _start(worker, timeout_s=120.0):
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(worker, timeout_s))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_port}"


def _stop(srv, t, worker=None):
    srv.shutdown()
    srv.server_close()
    t.join(10)
    assert not t.is_alive()
    if worker is not None and worker.is_alive():
        worker.close()
        worker.join(10)
        assert not worker.is_alive()


@pytest.fixture(scope="module")
def server(sessions):
    worker = serve.BatchWorker(*sessions, window_s=0.2)
    worker.start()
    srv, t, url = _start(worker)
    yield url, worker
    _stop(srv, t, worker)


def _image(w=500, h=150, seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    img[60:64, 50:w - 50] = 0
    for _ in range(4):
        y, x = rng.integers(10, h - 30), rng.integers(10, w - 40)
        img[y:y + 20, x:x + 4] = rng.integers(0, 60)
    return img


def _call(method, url, body=None):
    """One request with ``http.client`` (no proxy is consulted) ->
    (status, content type, body)."""
    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=120)
    try:
        conn.request(method, url[len(f"http://{parts.netloc}"):], body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _post(url, body):
    status, _, data = _call("POST", url, body)
    return status, json.loads(data)


def _get(url):
    return _call("GET", url)


def test_healthz(server):
    url, _ = server
    status, ctype, body = _get(url + "/healthz")
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == {"ok": True}


def test_binarize_endpoint(server, sessions):
    url, _ = server
    img = _image()
    status, out = _post(url + "/binarize", encode_png(img))
    assert status == 200
    assert (out["height"], out["width"]) == (150, 500)
    assert "strokes" not in out and out["batch_size"] >= 1
    mask = decode_png(base64.b64decode(out["binarized_png_b64"]))[:, :, 0]
    want = sessions[0].binarize_image(img)[:, :, 0]
    np.testing.assert_array_equal(mask, want)


def test_derender_matches_process_images(server, sessions):
    """The served strokes are process_images' strokes for the same image,
    rescaled to the input's height, as the CLI writes them."""
    url, _ = server
    binarizer, estimator = sessions
    img = _image(w=640, seed=3)  # a line whose strokes are not empty
    status, out = _post(url + "/derender", encode_png(img))
    assert status == 200 and "svg" not in out
    mask = binarizer.binarize_images([img])[0][:, :, 0] > 127
    want = strokes_to_json(estimator.process_images([mask])[0],
                           scale=img.shape[0] / mask.shape[0])
    assert out["strokes"] == json.loads(json.dumps(want))
    assert out["strokes"] and out["strokes_s"] >= 0


def test_derender_svg(server):
    url, _ = server
    status, out = _post(url + "/derender?svg=1", encode_png(_image()))
    assert status == 200
    root = ET.fromstring(out["svg"])
    assert root.attrib["viewBox"] == "0 0 500 150"  # the input's frame
    assert len(list(root)) == len(out["strokes"])


def test_grey_png_body(server):
    url, _ = server
    grey = _image()[:, :, 0]
    status, out = _post(url + "/binarize", encode_png(grey))
    assert status == 200 and out["width"] == 500


def test_concurrent_requests_ride_one_batch(server, sessions):
    """Requests sent together are answered from one batch; each gets the
    strokes of its own image."""
    url, worker = server
    imgs = [_image(w=420 + 40 * i, seed=i) for i in range(6)]
    results = [None] * len(imgs)
    calls = []
    real = worker.estimator.process_images

    def spy(masks, *a, **k):
        calls.append(len(masks))
        return real(masks, *a, **k)

    worker.estimator.process_images = spy
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(url + "/derender", encode_png(imgs[i]))))
            for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        worker.estimator.process_images = real
    assert all(status == 200 for status, _ in results)
    assert max(out["batch_size"] for _, out in results) > 1
    assert len(calls) < len(imgs) and sum(calls) == len(imgs)
    binarizer, estimator = sessions
    n_strokes = 0
    for img, (_, out) in zip(imgs, results):
        mask = binarizer.binarize_image(img)[:, :, 0] > 127
        want = strokes_to_json(estimator.process_image(mask),
                               scale=img.shape[0] / mask.shape[0])
        assert out["strokes"] == json.loads(json.dumps(want))
        n_strokes += len(want)
    assert n_strokes > 0


@pytest.mark.parametrize("body", [b"garbage not a png", b"",
                                  encode_png(np.zeros((4, 4), np.uint8))[:40]])
def test_bad_body_is_400(server, body):
    url, _ = server
    status, out = _post(url + "/binarize", body)
    assert status == 400 and out["error"].startswith("bad image")


def test_unknown_path_is_404(server):
    url, _ = server
    assert _post(url + "/nope", b"x")[0] == 404
    assert _get(url + "/nope")[0] == 404


def test_metrics_json_and_prometheus(server):
    url, _ = server
    _post(url + "/binarize", encode_png(_image()))
    _post(url + "/nope", b"x")
    m = json.loads(_get(url + "/metrics")[2])
    assert m["requests"]["/binarize"] >= 1 and m["errors"]["/nope"] >= 1
    assert m["batches"] >= 1 and m["uptime_s"] >= 0
    assert sum(m["batch_size_hist"].values()) == m["batches"]
    lat = m["latency_s"]["binarize"]
    assert lat["n"] >= 1 and lat["p50"] is not None
    status, ctype, body = _get(url + "/metrics?format=prom")
    assert status == 200 and ctype.startswith("text/plain")
    text = body.decode()
    assert 'sd_requests_total{endpoint="/binarize"}' in text
    assert "sd_uptime_seconds" in text and "sd_batches_total" in text
    assert 'sd_stage_latency_seconds{stage="binarize",quantile="p50"}' in text


def test_queue_wait_per_request(server):
    """Each request's wait in the queue until its batch started is one
    sample of the ``queue`` stage, in the JSON and the Prometheus text; a
    lone request waits out the batch window."""
    m = serve.Metrics()
    m.batch(2, 0.5, None, [0.01, 0.03])
    assert m.snapshot()["latency_s"]["queue"] == {
        "p50": 0.02, "p90": 0.028, "p99": 0.0298, "n": 2}
    assert m.snapshot()["latency_s"]["strokes"]["n"] == 0
    url, worker = server
    worker.metrics.lat["queue"].clear()
    _post(url + "/binarize", encode_png(_image()))
    q = json.loads(_get(url + "/metrics")[2])["latency_s"]["queue"]
    assert q["n"] == 1 and q["p50"] >= worker.window_s
    text = _get(url + "/metrics?format=prom")[2].decode()
    assert 'sd_stage_latency_seconds{stage="queue",quantile="p50"}' in text


def test_counters_hold_under_many_threads(server):
    """More request threads than cores with a short switch interval: every
    request is counted once."""
    url, _ = server
    before = json.loads(_get(url + "/metrics")[2])["requests"].get(
        "/binarize", 0)
    body = encode_png(_image(w=200, h=64))
    n = 16
    statuses = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: statuses.append(
            _post(url + "/binarize", body)[0])) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert statuses == [200] * n
    after = json.loads(_get(url + "/metrics")[2])["requests"]["/binarize"]
    assert after - before == n


class _Failing:
    config = BinarizerConfig()

    def binarize_images(self, images):
        raise RuntimeError("device lost")


def test_failed_batch_is_500_and_timeout_is_504(sessions):
    worker = serve.BatchWorker(_Failing(), sessions[1], window_s=0.01)
    worker.start()
    srv, t, url = _start(worker)
    try:
        status, out = _post(url + "/derender", encode_png(_image()))
        assert status == 500 and out["error"] == "RuntimeError: device lost"
        assert worker.is_alive()  # the worker goes on with the next batch
        assert json.loads(_get(url + "/metrics")[2])["errors"] == {
            "/derender": 1}
    finally:
        _stop(srv, t, worker)
    idle = serve.BatchWorker(*sessions)  # never started: nothing answers
    srv, t, url = _start(idle, timeout_s=0.05)
    try:
        status, out = _post(url + "/binarize", encode_png(_image()))
        assert status == 504 and out == {"error": "timeout"}
    finally:
        _stop(srv, t)


def test_main_needs_a_card_unless_cpu_is_asked(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--models", str(models), "--port", "0"])
    started = []

    class OneShot(ThreadingHTTPServer):
        def serve_forever(self, poll_interval=0.5):
            started.append(self.server_port)

    workers = []
    real = serve.BatchWorker

    def spy(*a, **k):
        workers.append(real(*a, **k))
        return workers[-1]

    monkeypatch.setattr(serve, "ThreadingHTTPServer", OneShot)
    monkeypatch.setattr(serve, "BatchWorker", spy)
    serve.main(["--models", str(models), "--port", "0", "--device", "cpu",
                "--decode", "beam", "--beam-size", "2",
                "--device-partition"])
    assert started and started[0] > 0
    assert workers[0].estimator.config.beam_size == 2
    assert workers[0].binarizer.device.type == "cpu"
    workers[0].join(10)
    assert not workers[0].is_alive()  # main closed it on the way out
    # --quant int8 (once refused) reaches both pipelines.
    serve.main(["--models", str(models), "--port", "0", "--device", "cpu",
                "--quant", "int8"])
    assert workers[1].binarizer.config.quant == "int8"
    assert workers[1].estimator.encoder.quant == "int8"
    workers[1].join(10)
    assert not workers[1].is_alive()

"""``utils/profiling`` and ``utils/flops`` of the port against the JAX
package's: the transfer ledger's bytes and events at the pipelines'
transfer sites (per image, batched, device and host partition) with
float32 outputs identical, ``chip_busy_ms`` on a synthetic trace against
JAX's on the same intervals in its format, ``device_trace`` on the CPU,
``StageTimer``, ``upload``, and ``flops`` against ``xla_flops``."""

import contextlib
import dataclasses
import gzip
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.ops.tiling import plan_tiles as j_plan_tiles
from stroke_derenderer_tpu.pipeline.strokes import (
    compute_partitions as j_compute_partitions,
)
from stroke_derenderer_tpu.utils import profiling as jp
from stroke_derenderer_tpu.utils.flops import xla_flops
from stroke_derenderer_tpu.weights.store import (
    binarizer_template, build_strokes_models,
)
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import config as tconfig
from stroke_derenderer_tpu_torch.weights import materialize_model_dir
from stroke_derenderer_tpu_torch.utils import profiling as tp
from stroke_derenderer_tpu_torch.utils.flops import (
    bench_flops_per_image, flops,
)

TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=10,
                        compute_dtype="float32")
# The JAX package pads tile and glyph batches on the host for its compile
# cache and uploads the pad rows; at buckets of 1 both packages move the
# same arrays, so their ledgers must agree byte for byte.
NO_PAD_BIN = {"batch_bucket": 1}
NO_PAD_SE = {"glyph_bucket": 1}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The port writes the model dir (flax's bytes; both packages load
    it)."""
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(
        d, tconfig.BinarizerConfig(**dataclasses.asdict(TINY_BIN)),
        tconfig.StrokesConfig(**{k: v for k, v in dataclasses.asdict(
            TINY_SE).items() if k in tconfig.StrokesConfig.__dataclass_fields__}))
    return d


def _line(rng, h, w):
    img = np.full((h, w, 3), 255, np.uint8)
    for _ in range(7):
        y, x = rng.integers(5, h - 20), rng.integers(0, w - 40)
        img[y:y + rng.integers(4, 16), x:x + rng.integers(5, 30)] = \
            rng.integers(0, 80)
    return img


def _images():
    """Three lines of one width (the batched fused program), two ragged."""
    rng = np.random.default_rng(0)
    return [_line(rng, 64, 300), _line(rng, 64, 300), _line(rng, 64, 300),
            _line(rng, 128, 500), _line(rng, 96, 301)]


def _masks():
    """Three masks of three glyph groups each, their islands drawn at
    random, and one without ink. One shape and one group count keep the
    JAX package to one compile per program (its buckets are 1 here)."""
    rng = np.random.default_rng(1)
    out = []
    for k in range(4):
        m = np.zeros((128, 512), np.uint8)
        for x0 in ((20, 200, 380) if k != 1 else ()):
            y0, x = rng.integers(10, 80), x0 + rng.integers(0, 10)
            m[y0:y0 + rng.integers(8, 40), x:x + rng.integers(5, 30)] = 255
        out.append(m)
    return out


def _delta(ledger, fn):
    before = ledger.snapshot()
    out = fn()
    return ledger.delta(before), out


def _same_strokes(a, b):
    assert len(a) == len(b)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


@pytest.fixture(scope="module")
def sessions(models):
    """(JAX binarizer, JAX estimator, port binarizer, port estimator) at
    unpadded buckets."""
    return (*j_cli.initialize_sessions(models, se_overrides=NO_PAD_SE,
                                       bin_overrides=NO_PAD_BIN),
            *cli.initialize_sessions(models, device="cpu",
                                     se_overrides=NO_PAD_SE,
                                     bin_overrides=NO_PAD_BIN))


@contextlib.contextmanager
def _config(*pipelines, **fields):
    """The pipelines' configs with ``fields`` replaced for the block (both
    packages read their config at call time)."""
    old = [p.config for p in pipelines]
    for p in pipelines:
        p.config = dataclasses.replace(p.config, **fields)
    try:
        yield
    finally:
        for p, c in zip(pipelines, old):
            p.config = c


@pytest.mark.parametrize("path", ["binarize_image", "binarize_images"])
def test_ledger_matches_jax_on_binarize(sessions, path):
    jb, _, tb, _ = sessions
    imgs = _images()
    if path == "binarize_image":
        for img in imgs[3:]:  # a line at the model height, a ragged one
            jd, jm = _delta(jp.LEDGER, lambda: jb.binarize_image(img))
            td, tm = _delta(tp.LEDGER, lambda: tb.binarize_image(img))
            assert td == jd and td[2:] == (1, 1)
            np.testing.assert_array_equal(tm, jm)
    else:
        jd, jm = _delta(jp.LEDGER, lambda: jb.binarize_images(imgs))
        td, tm = _delta(tp.LEDGER, lambda: tb.binarize_images(imgs))
        # One fused width group (up, down) and one bucketed tile batch.
        assert td == jd and td[2:] == (2, 2)
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ["process_image", "process_images"])
@pytest.mark.parametrize("dp,rle", [(True, True), (True, False),
                                    (False, True)],
                         ids=["device packed", "device dense",
                              "host partition"])
def test_ledger_matches_jax_on_strokes(sessions, path, dp, rle):
    """Bytes and events equal at every site, float32 strokes identical;
    the run-length packing moves fewer bytes up than the dense packing."""
    _, je, _, te = sessions
    masks = _masks()[:3]

    def run(est):
        if path == "process_image":
            return [est.process_image(m) for m in masks]
        return est.process_images(masks)

    with _config(je, te, device_partition=dp, gid_rle=rle):
        jd, js = _delta(jp.LEDGER, lambda: run(je))
        td, ts = _delta(tp.LEDGER, lambda: run(te))
    # One upload and one download for each mask with glyphs, or for the
    # batch.
    assert td[2:] == ((2, 2) if path == "process_image" else (1, 1))
    assert td == jd
    for a, b in zip(ts, js):
        _same_strokes(a, b)
    if dp and rle:
        with _config(te, gid_rle=False):
            dd, _ = _delta(tp.LEDGER, lambda: run(te))
        assert td[0] < dd[0] and td[1:] == dd[1:]


def test_ledger_against_jax_with_padded_buckets(sessions):
    """At the default ``batch_bucket`` the JAX package also uploads its pad
    tiles; the port pads on the device: the up bytes differ by exactly
    those tiles, everything else is equal."""
    jb, _, tb, _ = sessions
    img = _images()[3]
    with _config(jb, tb, batch_bucket=TINY_BIN.batch_bucket):
        jd, _ = _delta(jp.LEDGER, lambda: jb.binarize_image(img))
        td, _ = _delta(tp.LEDGER, lambda: tb.binarize_image(img))
    tiles = j_plan_tiles(int(img.shape[1] * 128 / img.shape[0]), 384,
                         64).num_tiles
    pad = -tiles % TINY_BIN.batch_bucket
    assert pad > 0
    assert jd[0] - td[0] == pad * 128 * 384 * 3
    assert jd[1:] == td[1:]


def test_timer_and_ledger_api_match_jax(monkeypatch):
    timers = []
    for mod in (tp, jp):
        clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125])
        monkeypatch.setattr(mod.time, "perf_counter",
                            lambda clock=clock: next(clock))
        timer = mod.StageTimer()
        for name in ("forward", "decode", "forward"):
            with timer(name):
                pass
        timers.append(timer)
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].as_dict() == timers[1].as_dict() == {
        "forward": {"total_s": 0.375, "calls": 2},
        "decode": {"total_s": 0.5, "calls": 1}}
    for ledger in (tp.TransferLedger(), jp.TransferLedger()):
        s0 = ledger.snapshot()
        ledger.add_up(np.zeros(10, np.int16), None,
                      (np.zeros(3, np.int32), [np.zeros(2, np.uint8)]))
        ledger.add_down(np.zeros((2, 3), np.float32))
        assert ledger.delta(s0) == (34, 24, 1, 1)
    assert tp.TransferLedger._nbytes([torch.zeros(4, dtype=torch.bfloat16)]
                                     ) == 8


def test_upload_is_one_hop_of_every_dtype():
    arrays = [np.arange(5, dtype=np.int16), np.ones((2, 3), bool),
              np.arange(7, dtype=np.uint8), np.linspace(0, 1, 3, dtype=
                                                        np.float32),
              np.arange(4, dtype=np.int64).reshape(2, 2)[:, ::-1],
              np.zeros((0, 4), np.int32), np.int8(-3) * np.ones(3, np.int8)]
    before = tp.LEDGER.snapshot()
    got = tp.upload("cpu", *arrays)
    assert tp.LEDGER.delta(before) == (sum(a.nbytes for a in arrays), 0, 1,
                                       0)
    for a, t in zip(arrays, got):
        assert t.shape == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    before = tp.LEDGER.snapshot()
    out = tp.download(torch.arange(6, dtype=torch.int16))
    assert tp.LEDGER.delta(before) == (0, 12, 0, 1)
    np.testing.assert_array_equal(out, np.arange(6))


# (start us, duration us) on the card's tracks: nested, overlapping,
# touching and apart; plus host events that must not count.
DEVICE_IV = [(100.0, 50.0), (110.0, 10.0), (140.0, 30.0), (170.0, 5.0),
             (300.0, 20.0), (305.0, 1.5), (400.0, 0.0), (500.0, 7.25)]
HOST_IV = [(0.0, 1000.0), (200.0, 50.0)]


def _port_trace(path):
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    events = [{"ph": "X", "cat": cats[i % 3], "name": f"k{i}", "pid": 0,
               "tid": 7, "ts": s, "dur": d}
              for i, (s, d) in enumerate(DEVICE_IV)]
    events += [{"ph": "X", "cat": c, "name": "host", "pid": 1, "tid": 1,
                "ts": s, "dur": d}
               for c, (s, d) in zip(("cpu_op", "python_function"), HOST_IV)]
    events += [{"ph": "X", "cat": "gpu_user_annotation", "name": "a",
                "pid": 0, "tid": 8, "ts": 0.0, "dur": 900.0},
               {"ph": "M", "name": "process_name", "pid": 0,
                "args": {"name": "python"}}]
    path.write_text(json.dumps({"traceEvents": events}))


def _jax_trace(path):
    events = [{"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "/device:TPU:0"}},
              {"ph": "M", "name": "process_name", "pid": 2,
               "args": {"name": "/host:CPU"}}]
    events += [{"ph": "X", "pid": 1, "tid": 1, "ts": s, "dur": d,
                "name": "op"} for s, d in DEVICE_IV]
    events += [{"ph": "X", "pid": 2, "tid": 1, "ts": s, "dur": d,
                "name": "host"} for s, d in HOST_IV]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_chip_busy_ms_matches_jax_on_the_same_intervals(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax" / "plugins").mkdir(parents=True)
    assert tp.chip_busy_ms(tmp_path / "port") is None
    _port_trace(tmp_path / "port" / "1.pt.trace.json")
    _jax_trace(tmp_path / "jax" / "plugins" / "h.trace.json.gz")
    got = tp.chip_busy_ms(tmp_path / "port")
    # [100, 175) + [300, 320) + [400, 400) + [500, 507.25) us.
    assert got == pytest.approx((75 + 20 + 7.25) / 1e3, abs=1e-12)
    assert got == jp.chip_busy_ms(tmp_path / "jax")
    # The port's reader takes the gzipped form too, and the newest trace.
    time.sleep(0.01)
    with gzip.open(tmp_path / "port" / "2.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [{"ph": "X", "cat": "kernel", "ts": 1.0,
                                    "dur": 2.0}]}, f)
    assert tp.chip_busy_ms(tmp_path / "port") == pytest.approx(0.002)
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "3.pt.trace.json").write_text(json.dumps(
        {"traceEvents": [{"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 9}]}))
    assert tp.chip_busy_ms(tmp_path / "host") is None


def test_device_trace_on_the_cpu(tmp_path):
    """On the CPU the trace is written and holds the host's ops, and no
    device interval: ``chip_busy_ms`` is None."""
    with tp.device_trace(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert tp.chip_busy_ms(tmp_path / "trace") is None


def _flops_pair(fn_jax, args_jax, module, args):
    with torch.device("meta"):
        got = flops(module(), *[torch.zeros(a) for a in args])
    return got / xla_flops(fn_jax, *args_jax)


def test_flops_against_xla():
    """The UNet at ``models_demo``'s widths and the tiny encoder within 2%
    of XLA's count. Measured on this CPU: UNet (16, 32, 64) + 128 1.0039,
    the tiny encoder 1.0046; where they part further the cause is what each
    counts (XLA counts elementwise work and leaves out a convolution's
    products with its zero padding): ResNet-18 1.072 (the 7 x 7 maps lose
    ~18% of their 3 x 3 taps to padding), the tiny UNet 0.970, the decoder
    step 0.768 (tiny widths) and 0.905 (64) of XLA's, which also counts the
    softmax, gates and activations."""
    from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
    from stroke_derenderer_tpu_torch.models.encoder import ResNetEncoder
    from stroke_derenderer_tpu_torch.models.unet import AttentionUNet

    # XLA counts from shapes alone: abstract variables, nothing is run.
    shape = jax.ShapeDtypeStruct
    key = jax.random.PRNGKey(0)
    jb = BinarizerConfig(features=(16, 32, 64), bottleneck=128,
                         compute_dtype="float32")
    unet, v = binarizer_template(jb)
    ratio = _flops_pair(lambda v, x: unet.apply(v, x),
                        (v, shape((1, 128, 384, 3), jnp.float32)),
                        lambda: AttentionUNet((16, 32, 64), 128, 3,
                                              dtype=torch.float32).eval(),
                        [(1, 128, 384, 3)])
    assert abs(ratio - 1) < 0.02, ratio
    enc, dec = build_strokes_models(TINY_SE)
    e = 64  # the tiny encoder's features
    ev = jax.eval_shape(enc.init, key, shape((1, 224, 224, 3), jnp.float32))
    dv = jax.eval_shape(dec.init, key, shape((1, 196, e), jnp.float32),
                        shape((1, 4), jnp.int32))
    ratio = _flops_pair(lambda v, x: enc.apply(v, x),
                        (ev, shape((2, 224, 224, 3), jnp.float32)),
                        lambda: ResNetEncoder("tiny",
                                              dtype=torch.float32).eval(),
                        [(2, 224, 224, 3)])
    assert abs(ratio - 1) < 0.02, ratio

    def step(v, s, emb, h, c):
        return dec.apply(v, s, dec.apply(v, s, method="project_encoding"),
                         emb, h, c, method="step")

    seq, z = shape((2, 196, e), jnp.float32), shape((2, 16), jnp.float32)
    proj = xla_flops(lambda v, s: dec.apply(v, s, method="project_encoding"),
                     dv, seq)
    want = xla_flops(step, dv, seq, z, z, z) - proj
    with torch.device("meta"):
        d = AttentiveDecoder(451, 16, 16, 16, e, dtype=torch.float32)
        s = torch.zeros(2, 196, e)
        z = torch.zeros(2, 16)
        got = flops(d.step, s, d.project_encoding(s), z, z, z)
    assert got / want == pytest.approx(0.768, abs=0.01)


def test_bench_flops_per_image_counts_the_jax_shapes():
    """Tiles and glyph groups as the JAX package counts them; each stage's
    FLOPs the sum of its parts' counts."""
    imgs = _images()[3:]
    got = bench_flops_per_image(imgs, 7, TINY_BIN, TINY_SE)
    assert set(got) == {"binarize_flops_per_image",
                        "strokes_flops_per_image", "decoder_step_flops",
                        "n_tiles", "n_glyphs"}
    from stroke_derenderer_tpu.ops.resize import resize_to_height_np
    rs = [resize_to_height_np(im, 128) for im in imgs]
    assert got["n_tiles"] == sum(j_plan_tiles(r.shape[1], 384, 64).num_tiles
                                 for r in rs)
    assert got["n_glyphs"] == sum(len(j_compute_partitions(
        r[:, :, 0] < 128, StrokesConfig())) for r in rs)
    assert got["decoder_step_flops"] > 0
    assert got["strokes_flops_per_image"] > 7 * got["decoder_step_flops"] / 2

"""The port's spans and counters (``utils/profiling.py``: ``span``,
``SPANS``, ``COUNTERS``) on the CPU: nothing entered and nothing counted
without a profile; under ``torch.profiler`` every ``sd.`` span of the
batched path in the exported trace, nested as named, and the decode's
row-steps equal to what the benchmark counts from the same calls; a new
profile starting from nothing; the decode counters' arithmetic."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import config as tconfig
from stroke_derenderer_tpu_torch.kernels import fused_beam
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.ops.device_partition import plan_partitions
from stroke_derenderer_tpu_torch.utils import profiling as tp
from stroke_derenderer_tpu_torch.weights import materialize_model_dir

TINY_BIN = tconfig.BinarizerConfig(features=(8, 16), bottleneck=16,
                                   compute_dtype="float32")
TINY_SE = tconfig.StrokesConfig(encoder_arch="tiny", embed_dim=16,
                                attention_dim=16, decoder_dim=16,
                                max_length=12, compute_dtype="float32")
BINARIZE_SPANS = ("sd.binarize", "sd.binarize.prep", "sd.binarize.launch",
                  "sd.binarize.wait", "sd.binarize.unpack")
STROKES_SPANS = ("sd.strokes", "sd.strokes.components", "sd.strokes.grouping",
                 "sd.strokes.gather", "sd.strokes.encode", "sd.strokes.decode",
                 "sd.strokes.wait", "sd.strokes.polylines")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    return d


@pytest.fixture(scope="module")
def sessions(models):
    """The tiny pipelines, the decoder's EOS logit raised so that rows end
    at different steps (2 or all 12 on these masks)."""
    binarizer, estimator = cli.initialize_sessions(models, device="cpu")
    with torch.no_grad():
        estimator.decoder.bfc[2] += 0.5
    return binarizer, estimator


def _line(rng, h, w):
    img = np.full((h, w, 3), 255, np.uint8)
    for _ in range(7):
        y, x = rng.integers(5, h - 20), rng.integers(0, w - 40)
        img[y:y + rng.integers(4, 16), x:x + rng.integers(5, 30)] = \
            rng.integers(0, 80)
    return img


def _images():
    """Three lines of one width (the batched fused program) and two ragged
    ones (the bucketed tile batch)."""
    rng = np.random.default_rng(0)
    return [_line(rng, 64, 300), _line(rng, 64, 300), _line(rng, 64, 300),
            _line(rng, 128, 500), _line(rng, 96, 301)]


def _masks():
    """Three masks of three glyph groups each and one without ink."""
    rng = np.random.default_rng(1)
    out = []
    for k in range(4):
        m = np.zeros((128, 512), bool)
        for x0 in ((20, 200, 380) if k != 1 else ()):
            y0, x = rng.integers(10, 80), x0 + rng.integers(0, 10)
            m[y0:y0 + rng.integers(8, 40), x:x + rng.integers(5, 30)] = True
        out.append(m)
    return out


def _steps(tokens, max_length):
    """Steps each greedy row ran, as the benchmark counts them: through its
    first EOS, else all."""
    eos = tokens == 2
    return np.where(eos.any(1), eos.argmax(1) + 1, max_length)


def _fresh():
    tp.COUNTERS.clear()
    tp.SPANS.clear()


def test_recording_flag_flips_under_the_profiler():
    assert not tp.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tp.recording()
    assert not tp.recording()


def test_nothing_entered_or_counted_without_a_profile(sessions, monkeypatch):
    binarizer, estimator = sessions
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    _fresh()
    binarizer.binarize_images(_images())
    estimator.process_images(_masks())
    assert entered == []
    assert tp.span("sd.x") is tp.span("sd.y")
    assert tp.COUNTERS.snapshot() == {} and tp.SPANS.records() == []
    tp.COUNTERS.add("n", 3)
    tp.COUNTERS.defer(lambda: {"n": 1})
    assert tp.COUNTERS.snapshot() == {}


def _nested_as_named(events):
    """Every ``sd.a.b`` event lies inside an ``sd.a`` event of its thread."""
    for e in events:
        parent = e["name"].rsplit(".", 1)[0]
        if parent == "sd":
            continue
        assert any(p["name"] == parent and p["tid"] == e["tid"]
                   and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                   for p in events), e["name"]


def test_spans_and_counters_of_the_batched_path(sessions, tmp_path,
                                                monkeypatch):
    binarizer, estimator = sessions
    tokens = []
    process_tokens = estimator.process_tokens

    def catch(toks, partitions):
        tokens.append(toks)
        return process_tokens(toks, partitions)

    monkeypatch.setattr(estimator, "process_tokens", catch)
    # The decode's count runs after the profile: no work of its own in it.
    counted_while = []
    steps_of = fd.greedy_steps

    def steps_w(preds, max_length):
        counted_while.append(tp.recording())
        return steps_of(preds, max_length)

    monkeypatch.setattr(fd, "greedy_steps", steps_w)
    images, masks = _images(), _masks()
    _fresh()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bins = binarizer.binarize_images(images)
        estimator.process_images(masks)
    counts = tp.COUNTERS.snapshot()
    assert counted_while == [False]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("sd.")]
    names = {e["name"] for e in events}
    assert names == set(BINARIZE_SPANS + STROKES_SPANS)
    _nested_as_named(events)
    assert sum(e["name"] == "sd.strokes.polylines" for e in events) == 3
    assert sum(e["name"] == "sd.strokes.components" for e in events) == 4
    # The log holds the same spans, each child inside its parent.
    recs = tp.SPANS.records()
    assert sorted(r.name for r in recs) == sorted(e["name"] for e in events)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is None:
            assert r.name in ("sd.binarize", "sd.strokes")
        else:
            p = by_id[r.parent]
            assert r.name.rsplit(".", 1)[0] == p.name
            assert p.start <= r.start <= r.end <= p.end

    rows = sum(len(p.partitions) for p in (
        plan_partitions(m, estimator.config.margin, estimator.config.image_size)
        for m in masks) if p is not None)
    steps = np.concatenate([_steps(t, TINY_SE.max_length) for t in tokens])
    assert len(bins) == 5 and rows == 9 and len(steps) == rows
    assert 1 < steps.min() < steps.max() == TINY_SE.max_length
    assert counts == {"decode_row_steps": int(steps.sum()),
                      "decode_row_slots": int(steps.max()) * rows}
    _fresh()


def test_beam_counts_each_image_until_its_last_beam(sessions, monkeypatch):
    _, estimator = sessions
    k = 3
    lens = []
    select = fused_beam.select_beam

    def catch(preds, score, lns, length_penalty=0.0):
        lens.append(lns)
        return select(preds, score, lns, length_penalty)

    monkeypatch.setattr(fused_beam, "select_beam", catch)
    monkeypatch.setattr(estimator, "config", dataclasses.replace(
        estimator.config, decode="beam", beam_size=k))
    _fresh()
    with profile(activities=[ProfilerActivity.CPU]):
        estimator.process_images(_masks()[:3])
    counts = tp.COUNTERS.snapshot()
    steps = lens[0].max(1).values.numpy()
    assert len(steps) == 6 and steps.min() < steps.max()
    assert counts["decode_row_steps"] == k * int(steps.sum())
    assert counts["decode_row_slots"] == k * int(steps.max()) * 6
    _fresh()


def test_redecode_passes_lie_inside_strokes(sessions, monkeypatch):
    """A residual pass's gathers and launches are spans of ``sd.strokes``
    as the first pass's are, and its decode is counted."""
    _, estimator = sessions
    monkeypatch.setattr(estimator, "config", dataclasses.replace(
        estimator.config, redecode_coverage=0.99, redecode_passes=1,
        refine_snap=2.0))
    with profile(activities=[ProfilerActivity.CPU]):
        estimator.process_images(_masks())
    recs = tp.SPANS.records()
    by_id = {r.id: r for r in recs}
    decodes = [r for r in recs if r.name == "sd.strokes.decode"]
    assert len(decodes) == 2
    assert all(by_id[r.parent].name == "sd.strokes" for r in recs
               if r.parent is not None)
    assert sum(r.parent is None for r in recs) == 1
    assert tp.COUNTERS.snapshot()["decode_row_steps"] > 0


def test_a_new_profile_starts_from_nothing(sessions):
    """The first span or count of a profile clears what an earlier one
    left, pending decode counts included; a span or count seen without a
    profile between them is what marks the new one."""
    _, estimator = sessions
    masks = _masks()
    estimator.process_images(masks[:1])
    with profile(activities=[ProfilerActivity.CPU]):
        estimator.process_images(masks[:1])
    alone = tp.COUNTERS.snapshot()
    assert alone["decode_row_slots"] > 0
    with tp.span("sd.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        estimator.process_images(masks)
    assert tp.COUNTERS._pending
    with tp.span("sd.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        tp.COUNTERS.add("n", 2)
        estimator.process_images(masks[:1])
    assert [r.name for r in tp.SPANS.records()].count("sd.strokes") == 1
    assert tp.COUNTERS.snapshot() == alone | {"n": 2}
    _fresh()


def test_decode_counts_arithmetic():
    preds = torch.tensor([[5, 2, 0, 0], [5, 6, 7, 8], [2, 0, 0, 0]])
    steps = fd.greedy_steps(preds, 4)
    assert steps.tolist() == [2, 4, 1]
    assert fd.decode_counts(steps, 1, 10, 3) == {
        "decode_row_slots": 12, "decode_row_steps": 7}
    fixstat = torch.tensor([[3, 99], [4, 7]], dtype=torch.int32)
    # Beam: 3 images of 2 beams; 6 rows x A + E = 10 in the prologue, then
    # 14 row-steps x (4 x 3 + 10).
    assert fd.decode_counts(steps, 2, 10, 3, fixstat) == {
        "decode_row_slots": 24, "decode_row_steps": 14,
        "decode_fixed_elements": 7, "decode_fix_checked": 60 + 14 * 22}
    assert fd.decode_counts(torch.zeros(0, dtype=torch.int32), 1, 10, 3) == {
        "decode_row_slots": 0, "decode_row_steps": 0}


def test_counters_hold_under_many_threads():
    """More threads than cores, a short switch interval: no add is lost."""
    import sys
    import threading
    _fresh()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work():
                for _ in range(200):
                    tp.COUNTERS.add("n")
                    with tp.span("sd.t"):
                        pass
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert tp.COUNTERS.snapshot() == {"n": 3200}
    assert len(tp.SPANS.records()) == 3200
    _fresh()

"""The readers of the program's own spans and counters (``harness/program.py``
and the metrics that use it): self time with nested children, idle time
partly under a layer span and partly under only an outermost one, the
counters' ratios, None against a program that keeps neither;
``trace.load`` unmoved by the program's ``sd.`` events; and on the CPU, a
tiny traced call whose program spans the reader puts on the trace's clock
where the trace itself has them."""

import json
import types

import pytest

from harness import cell as cells
from harness import program, trace
from harness.cell import metric_reader

# Each reader of a span's self time and the span it reads.
SELF = {"components_ms_per_img": "sd.strokes.components",
        "grouping_ms_per_img": "sd.strokes.grouping",
        "polylines_ms_per_img": "sd.strokes.polylines",
        "gather_ms_per_img": "sd.strokes.gather",
        "encode_enqueue_ms_per_img": "sd.strokes.encode",
        "decode_enqueue_ms_per_img": "sd.strokes.decode",
        "strokes_wait_ms_per_img": "sd.strokes.wait",
        "binarize_prep_ms_per_img": "sd.binarize.prep",
        "binarize_launch_ms_per_img": "sd.binarize.launch",
        "binarize_wait_ms_per_img": "sd.binarize.wait",
        "binarize_unpack_ms_per_img": "sd.binarize.unpack"}
NEW = tuple(SELF) + ("idle_unattributed_share", "decode_step_fill",
                     "decode_fix_share")


class Rec(types.SimpleNamespace):
    """A span record as the program's ``SpanRecord`` has it."""


def _rec(i, parent, name, start, end):
    return Rec(id=i, parent=parent, name=name, start=start, end=end)


def _traced(window=(0.0, 10.0), busy=(), spans=None, lines=2):
    return trace.Traced(window, spans or {}, [(s, e, "k") for s, e in busy],
                        list(busy), [{"lines": lines}], {}, {})


def test_self_time_less_nested_children(monkeypatch):
    ms = 1e-3
    recs = [_rec(0, None, "sd.strokes", 0, 10 * ms),
            _rec(1, 0, "sd.strokes.components", 1 * ms, 3 * ms),
            _rec(2, 0, "sd.strokes.grouping", 3 * ms, 6 * ms),
            _rec(3, 2, "sd.strokes.grouping.inner", 4 * ms, 5 * ms),
            _rec(4, 0, "sd.strokes.polylines", 7 * ms, 7.5 * ms),
            _rec(5, None, "sd.binarize", 20 * ms, 30 * ms),
            _rec(6, 5, "sd.binarize.prep", 20 * ms, 24 * ms),
            _rec(7, 5, "sd.binarize.unpack", 28 * ms, 29 * ms)]
    monkeypatch.setattr(program, "records", lambda: recs)
    t = program.self_times(recs)
    assert t["sd.strokes"] == pytest.approx(4.5 * ms)
    assert t["sd.strokes.grouping"] == pytest.approx(2 * ms)
    run = _traced(lines=2)
    want = {"components_ms_per_img": 1.0, "grouping_ms_per_img": 1.0,
            "polylines_ms_per_img": 0.25, "binarize_prep_ms_per_img": 2.0,
            "binarize_unpack_ms_per_img": 0.5}
    for name, v in want.items():
        assert metric_reader(name)(run) == pytest.approx(v), name
    assert program.self_ms_per_img(run, "sd.strokes.wait") is None
    assert program.self_ms_per_img(_traced(lines=0), "sd.strokes") is None


@pytest.mark.parametrize("name", sorted(SELF))
def test_each_span_reader_reads_its_span(monkeypatch, name):
    """A span of 3 ms with a child of 1 ms, over 2 lines: 1 ms a line."""
    ms = 1e-3
    recs = [_rec(0, None, SELF[name].rsplit(".", 1)[0], 0, 9 * ms),
            _rec(1, 0, SELF[name], 1 * ms, 4 * ms),
            _rec(2, 1, SELF[name] + ".inner", 2 * ms, 3 * ms)]
    monkeypatch.setattr(program, "records", lambda: recs)
    assert metric_reader(name)(_traced(lines=2)) == pytest.approx(1.0)


def test_idle_partly_under_a_span(monkeypatch):
    # The program's clock runs 100 s ahead of the trace's; each outer
    # span lies 0.1 s inside the benchmark's around it at each end.
    recs = [_rec(0, None, "sd.binarize", 100.5, 103.0),
            _rec(1, 0, "sd.binarize.prep", 100.5, 101.5),
            _rec(2, 0, "sd.binarize.wait", 101.5, 102.5),
            _rec(3, 2, "sd.binarize.wait.inner", 101.8, 102.0),
            _rec(4, None, "sd.strokes", 104.1, 108.9),
            _rec(5, 4, "sd.strokes.components", 104.5, 106.5)]
    monkeypatch.setattr(program, "records", lambda: recs)
    run = _traced(busy=[(1.0, 2.0), (6.0, 7.0), (9.5, 9.8)],
                  spans={"binarize": [(0.4, 3.1)], "strokes": [(4.0, 9.0)]})
    assert program.trace_offset(run, recs) == pytest.approx(-100.0)
    assert program.layer_self_intervals(recs) == [
        (100.5, 101.5), (101.5, 101.8), (102.0, 102.5), (101.8, 102.0),
        (104.5, 106.5)]
    # Idle 10 - 2.3 = 7.7 s. The layers are innermost over 0.5-2.5 (1 s of
    # it busy) and 4.5-6.5 (0.5 s busy): 2.5 s of the idle time explained;
    # the outer spans' own 2.5-3.0 and 4.1-4.5 and 6.5-8.9 explain none.
    got = metric_reader("idle_unattributed_share")(run)
    assert got == pytest.approx((7.7 - 2.5) / 7.7 * 100)
    # Calls that do not pair up are not aligned.
    run.spans["strokes"].append((9.6, 9.9))
    assert metric_reader("idle_unattributed_share")(run) is None


def test_counter_ratios(monkeypatch):
    counts = {"decode_row_steps": 300, "decode_row_slots": 1200,
              "decode_fixed_elements": 6, "decode_fix_checked": 3000}
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert metric_reader("decode_step_fill")(_traced()) == pytest.approx(25.0)
    assert metric_reader("decode_fix_share")(_traced()) == pytest.approx(0.2)
    counts = {"decode_row_steps": 0, "decode_row_slots": 0}
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert metric_reader("decode_step_fill")(_traced()) is None
    assert metric_reader("decode_fix_share")(_traced()) is None


def test_a_program_without_spans_or_counters_reads_nothing(monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: types.SimpleNamespace())
    run = _traced(busy=[(1.0, 2.0)], spans={"binarize": [(0, 3)],
                                           "strokes": [(4, 9)]})
    assert program.counters() is None and program.records() is None
    for name in NEW:
        assert metric_reader(name)(run) is None, name


def _events(with_program: bool, kernel: str) -> list:
    """A trace of two calls: the benchmark's spans, device work (the decode
    kernel, a convolution, a copy), a host op and, optionally, the
    program's spans."""
    ev = []

    def x(cat, name, ts, dur, **extra):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "pid": 1, "tid": 1, **extra})

    for c, t0 in enumerate((1000.0, 9000.0)):
        x("user_annotation", "bench.call", t0, 7000)
        x("user_annotation", "bench.binarize", t0 + 10, 2000)
        x("user_annotation", "bench.strokes", t0 + 2100, 4800)
        x("kernel", "void cudnn_conv<float>(int)", t0 + 500, 700 + c)
        x("gpu_memcpy", "Memcpy HtoD", t0 + 2300, 40)
        x("kernel", f"void (anonymous namespace)::{kernel}<__nv_bfloat16>"
          "(sd::Params<__nv_bfloat16>)", t0 + 3000, 1500)
        x("cpu_op", "aten::add", t0 + 20, 5)
        if with_program:
            x("user_annotation", "sd.binarize", t0 + 12, 1990)
            x("user_annotation", "sd.binarize.prep", t0 + 15, 300)
            x("user_annotation", "sd.strokes", t0 + 2105, 4790)
            x("user_annotation", "sd.strokes.components", t0 + 2110, 100)
            x("user_annotation", "sd.strokes.decode", t0 + 2900, 120)
    x("kernel", "void late_kernel(int)", 16500.0, 3000)
    return ev


@pytest.mark.parametrize("name, kernel", [
    ("demo.batch_greedy", "greedy_decode_kernel"),
    ("upstream.batch_greedy", "greedy_decode_kernel"),
    ("demo.batch_beam", "beam_decode_kernel")])
def test_trace_load_is_unmoved_by_program_spans(tmp_path, name, kernel):
    cell = cells.load(name)
    calls = [{"lines": 32, "tiles": 190, "rows": 470, "steps": [40] * 470}] * 2
    runs = []
    for with_program in (False, True):
        path = tmp_path / f"t{int(with_program)}.json"
        path.write_text(json.dumps({"traceEvents": _events(with_program, kernel)}))
        runs.append(trace.load(path, calls, cell.config, cell.traffic))
    a, b = runs
    assert (a.spans, a.window, a.kernels, a.busy) == (b.spans, b.window, b.kernels, b.busy)
    assert set(a.spans) == {"call", "binarize", "strokes"}
    assert trace.breakdown(a) == trace.breakdown(b)
    for m in cell.per_layer:
        if m["name"] in NEW:
            continue
        va, vb = metric_reader(m["name"])(a), metric_reader(m["name"])(b)
        assert va is not None and va == vb, m["name"]


def test_program_spans_land_where_the_trace_has_them(tmp_path):
    """A tiny traced call on the CPU, the benchmark's spans around the
    program's calls as the runner places them: the reader puts each of the
    program's spans within 1 ms of its own event in the exported trace, and
    every new reader of a span gives a value."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import numpy as np
    from stroke_derenderer_tpu_torch import cli
    from stroke_derenderer_tpu_torch import config as tconfig
    from stroke_derenderer_tpu_torch.utils import profiling
    from stroke_derenderer_tpu_torch.weights import materialize_model_dir

    materialize_model_dir(
        tmp_path, tconfig.BinarizerConfig(features=(8, 16), bottleneck=16,
                                          compute_dtype="float32"),
        tconfig.StrokesConfig(encoder_arch="tiny", embed_dim=16,
                              attention_dim=16, decoder_dim=16, max_length=8,
                              compute_dtype="float32"))
    binarizer, estimator = cli.initialize_sessions(tmp_path, device="cpu")
    rng = np.random.default_rng(0)
    lines = []
    for w in (300, 300, 300, 420):
        img = np.full((64, w, 3), 255, np.uint8)
        for x in range(10, w - 30, 40):
            img[10 + rng.integers(0, 20):40, x:x + rng.integers(5, 25)] = 0
        lines.append(img)
    profiling.SPANS.clear()
    profiling.COUNTERS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("bench.call"):
                with record_function("bench.binarize"):
                    bins = binarizer.binarize_images(lines)
                with record_function("bench.strokes"):
                    estimator.process_images([m[:, :, 0] > 127 for m in bins])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    run = trace.load(path, [{"lines": len(lines)}] * 2, {}, {})
    events = sorted((e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                    for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"].startswith("sd."))
    recs = program.records()
    off = program.trace_offset(run, recs)
    on = sorted((r.name, r.start + off, r.end + off) for r in recs)
    assert [n for n, _, _ in on] == [n for n, _, _ in events]
    err = max(max(abs(s - ts), abs(e - te))
              for (_, s, e), (_, ts, te) in zip(on, events))
    assert err < 1e-3, err
    for name in SELF:
        v = metric_reader(name)(run)
        assert v is not None and v >= 0, name
    assert 0 <= metric_reader("idle_unattributed_share")(run) <= 100
    assert 0 < metric_reader("decode_step_fill")(run) <= 100
    assert metric_reader("decode_fix_share")(run) is None   # no tensor cores
    profiling.SPANS.clear()
    profiling.COUNTERS.clear()

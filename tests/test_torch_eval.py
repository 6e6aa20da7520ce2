"""The port's evaluator and what it reads, against the JAX package's: every
metric on seeded masks and polylines (empty inputs too), the synthetic and
letterform generators (same draws, same generator state afterwards), the
real-pair loaders on ``examples/real_data``, ``evaluate_full`` for every
style and ``evaluate_real`` on a tiny float32 model, and the committed JAX
reference that ``chip_smoke.py`` holds the card to."""

import json
from pathlib import Path

import numpy as np
import pytest

from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.data import letters as jlet
from stroke_derenderer_tpu.data import real as jreal
from stroke_derenderer_tpu.data import synthetic as jsyn
from stroke_derenderer_tpu.eval import metrics as jm
from stroke_derenderer_tpu.eval import run as jrun
from stroke_derenderer_tpu.io.images import load_image as j_load_image
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch.data import letters as tlet
from stroke_derenderer_tpu_torch.data import real as treal
from stroke_derenderer_tpu_torch.data import synthetic as tsyn
from stroke_derenderer_tpu_torch.eval import metrics as tm
from stroke_derenderer_tpu_torch.eval import run as trun
from stroke_derenderer_tpu_torch.io import load_image

REPO = Path(__file__).resolve().parent.parent
REAL = REPO / "examples" / "real_data"
TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=16,
                        compute_dtype="float32")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    return d


def _polylines(rng, n, lo=1, hi=30):
    out = []
    for _ in range(n):
        k = int(rng.integers(lo, hi))
        xy = rng.normal(0, 5, (k, 2)).cumsum(0) + rng.uniform(0, 200, 2)
        out.append((xy[:, 0], xy[:, 1]))
    return out


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


def _same_state(r1, r2):
    assert r1.bit_generator.state == r2.bit_generator.state


MASK_PAIRS = [((40, 60), 0.3, 0.5), ((40, 60), 0.0, 0.4), ((40, 60), 0.0, 0.0),
              ((128, 300), 0.1, 0.1)]


@pytest.mark.parametrize("shape,p_pred,p_tgt", MASK_PAIRS)
def test_mask_metrics_match_jax(shape, p_pred, p_tgt):
    rng = np.random.default_rng(int(p_pred * 10 + p_tgt * 100))
    pred = rng.random(shape) < p_pred
    tgt = rng.random(shape) < p_tgt
    assert tm.binarization_f1(pred, tgt) == jm.binarization_f1(pred, tgt)
    for tol in (1, 2):
        assert (tm.binarization_f1_tol(pred, tgt, tol)
                == jm.binarization_f1_tol(pred, tgt, tol))


@pytest.mark.parametrize("seed", range(4))
def test_stroke_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = _polylines(rng, int(rng.integers(1, 7)))
    tgt = _polylines(rng, int(rng.integers(1, 7)))
    pred.append((np.zeros(0), np.zeros(0)))  # an empty stroke is skipped
    cases = [(pred, tgt), (pred, []), ([], tgt), ([], []), (tgt, tgt)]
    for p, t in cases:
        for name in ("stroke_dtw", "stroke_dtw_assigned", "stroke_dtw_split",
                     "strokes_chamfer", "stroke_coverage", "evaluate_pair"):
            args = (p, t) if name != "evaluate_pair" else (
                np.ones((4, 4)), np.eye(4), p, t)
            _same(getattr(tm, name)(*args), getattr(jm, name)(*args))
    for (ax, ay), (bx, by) in zip(pred[:3], tgt[:3]):
        a, b = np.stack([ax, ay], -1), np.stack([bx, by], -1)
        assert tm._dtw(a, b) == jm._dtw(a, b)
        assert tm._dtw_loop(a, b) == jm._dtw_loop(a, b)
        assert tm._dtw(a, b) == pytest.approx(tm._dtw_loop(a, b))
    assert tm._dtw(np.zeros((0, 2)), np.ones((3, 2))) == float("inf")
    _same(tm._densify(tgt, 0.5), jm._densify(tgt, 0.5))


@pytest.mark.parametrize("seed", range(3))
def test_synthetic_generators_match_jax(seed):
    shape = (128, 384)
    calls = [
        lambda m, r: m.random_strokes(r, 4, shape),
        lambda m, r: m.random_strokes(r, 2, shape, points_per_stroke=40),
        lambda m, r: m._curl_stroke(r, shape, 30),
        lambda m, r: m._travel_curl_stroke(r, shape, 40),
        lambda m, r: m._zigzag_stroke(r, shape, 20),
        lambda m, r: m._smooth_stroke(r, shape, 12),
        lambda m, r: m.mixed_strokes(r, shape, token_budget=380,
                                     max_strokes=3),
        lambda m, r: m.mixed_strokes(r, shape, token_budget=380,
                                     max_strokes=3,
                                     style_probs=m.HAND_PROBS),
        lambda m, r: m.mixed_strokes(r, (128, 128), token_budget=12),
    ]
    for i, call in enumerate(calls):
        rt, rj = (np.random.default_rng([seed, i]) for _ in range(2))
        _same(call(tsyn, rt), call(jsyn, rj))
        _same_state(rt, rj)
    rt, rj = (np.random.default_rng(seed) for _ in range(2))
    strokes = tsyn.random_strokes(rt, 5, shape)
    jsyn.random_strokes(rj, 5, shape)
    for th in (1, 2, 3):
        _same(tsyn.rasterize_strokes(strokes, shape, th),
              jsyn.rasterize_strokes(strokes, shape, th))
    mask = tsyn.rasterize_strokes(strokes, shape, 2)
    for ruled in (False, True):
        _same(tsyn._photo_render(mask, rt, ruled=ruled),
              jsyn._photo_render(mask, rj, ruled=ruled))
        _same_state(rt, rj)
    _same(tsyn.rasterize_strokes([(np.array([3.0]), np.array([4.0]))],
                                 shape), np.zeros(shape, np.uint8))
    np.testing.assert_array_equal(tsyn._RULE_COLORS, jsyn._RULE_COLORS)
    assert tsyn.HAND_PROBS == jsyn.HAND_PROBS


@pytest.mark.parametrize("seed", range(3))
def test_letter_generators_match_jax(seed):
    assert tlet.LETTER_TEMPLATES.keys() == jlet.LETTER_TEMPLATES.keys()
    for c, (adv, strokes) in tlet.LETTER_TEMPLATES.items():
        assert adv == jlet.LETTER_TEMPLATES[c][0]
        _same(strokes, jlet.LETTER_TEMPLATES[c][1])
    rt, rj = (np.random.default_rng(seed) for _ in range(2))
    for shape, budget in [((128, 512), 380), ((128, 128), 380),
                          ((128, 20), 380), ((128, 256), 20)]:
        for n in (None, 3):
            wt, wj = tlet.sample_word(rt, n), jlet.sample_word(rj, n)
            assert wt == wj
            _same(tlet.word_strokes(rt, wt, shape, token_budget=budget),
                  jlet.word_strokes(rj, wj, shape, token_budget=budget))
            _same_state(rt, rj)
    _same(tlet.word_strokes(rt, "xyz!", (128, 300), slant=0.1, jitter=0.0,
                            join_prob=1.0),
          jlet.word_strokes(rj, "xyz!", (128, 300), slant=0.1, jitter=0.0,
                            join_prob=1.0))
    _same_state(rt, rj)


def test_discover_pairs_matches_jax():
    pairs = treal.discover_pairs(REAL)
    assert len(pairs) == 44
    assert pairs == jreal.discover_pairs(REAL)
    assert treal.discover_pairs(REPO / "models_demo") == []


@pytest.mark.parametrize("index", [0, 17, 43])
def test_load_pair_matches_jax(index):
    png, sj = treal.discover_pairs(REAL)[index]
    for height in (128, 64):
        _same(treal.load_pair(png, sj, height), jreal.load_pair(png, sj,
                                                                height))


def test_load_pair_without_a_mask_rasterizes_the_strokes(tmp_path):
    png, sj = treal.discover_pairs(REAL)[1]
    for src in (png, sj):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    args = (tmp_path / png.name, tmp_path / sj.name, 128, 3)
    _same(treal.load_pair(*args), jreal.load_pair(*args))


def test_load_image_matches_jax_on_every_real_png():
    pngs = sorted(REAL.glob("*.png"))
    assert len(pngs) == 88
    for p in pngs:
        np.testing.assert_array_equal(load_image(p), j_load_image(str(p)))


@pytest.mark.parametrize("style", ["smooth", "mixed", "hand", "letters"])
def test_evaluate_full_matches_jax(models, style):
    got = trun.evaluate_full(models, n=2, width=500, style=style,
                             device="cpu")
    want = jrun.evaluate_full(models, n=2, width=500, style=style)
    _same(got, want)
    json.dumps(got)


@pytest.mark.parametrize("kwargs", [
    {"dense": True, "ruled": 1.0}, {"binarizer_only": True},
    {"se_overrides": {"redecode_coverage": 0.9, "refine_snap": 3.0}}],
    ids=["dense_ruled", "binarizer_only", "redecode_refine"])
def test_evaluate_full_options_match_jax(models, kwargs):
    got = trun.evaluate_full(models, n=2, width=500, device="cpu", **kwargs)
    _same(got, jrun.evaluate_full(models, n=2, width=500, **kwargs))


def test_evaluate_real_matches_jax(models, tmp_path):
    for png, sj in treal.discover_pairs(REAL)[:2]:
        for src in (png, sj, png.with_name(f"{png.stem}_BINARIZED.png")):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    got = trun.evaluate_real(models, tmp_path, device="cpu")
    assert got["n"] == 2
    _same(got, jrun.evaluate_real(models, tmp_path))
    with pytest.raises(FileNotFoundError):
        trun.evaluate_real(models, tmp_path / "none", device="cpu")


def test_main_prints_one_json_line(models, tmp_path, capsys):
    assert trun.main(["--models", str(models), "--n", "1",
                      "--binarizer-only", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.keys() == {"n", "binarization_f1"}
    assert trun.main(["--models", str(models), "--n", "1", "--quant",
                      "int8", "--binarizer-only", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.keys() == {"n", "binarization_f1"}


def test_main_needs_a_card_unless_cpu_is_asked(models, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--models", str(models), "--n", "1"])


def test_committed_jax_reference_names_the_three_runs():
    """``tests/golden/jax_cpu_eval.json`` (``scripts/jax_cpu_eval.py``):
    the three runs ``chip_smoke.py`` holds the card to, each with its
    command and every key the evaluator returns."""
    ref = json.loads((REPO / "tests" / "golden" / "jax_cpu_eval.json")
                     .read_text())
    assert set(ref["runs"]) == {"real_greedy", "real_redecode",
                                "mixed_greedy"}
    assert ref["commit"] and ref["jax_version"]
    keys = {"n", "binarization_f1", "stroke_dtw", "stroke_dtw_ci95",
            "stroke_dtw_failures", "stroke_dtw_assigned", "stroke_dtw_split",
            "stroke_chamfer", "stroke_coverage"}
    for name, run in ref["runs"].items():
        assert "stroke_derenderer_tpu.eval.run" in run["command"]
        extra = {"binarization_f1_tol1"} if name.startswith("real") else set()
        assert set(run["result"]) == keys | extra
        assert run["result"]["stroke_dtw_ci95"] > 0
    assert ref["runs"]["real_greedy"]["result"]["n"] == 44
    assert "--redecode 0.9" in ref["runs"]["real_redecode"]["command"]
    assert ref["runs"]["mixed_greedy"]["result"]["n"] == 50
    # The port's own CPU runs beside them (bfloat16) meet the card's bars.
    for name, run in ref["port_cpu"]["runs"].items():
        got, want = run["result"], ref["runs"][name]["result"]
        assert "--device cpu" in run["command"]
        assert abs(got["stroke_dtw"] - want["stroke_dtw"]) <= want[
            "stroke_dtw_ci95"]
        for key in ("binarization_f1", "binarization_f1_tol1"):
            if key in want:
                assert abs(got[key] - want[key]) <= 0.002
        assert abs(got["stroke_coverage"] - want["stroke_coverage"]) <= 0.03

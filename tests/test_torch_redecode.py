"""The port's residual re-decode and ink-snap refinement against the JAX
package's, on a tiny float32 model and numpy-seeded inputs: the stroke
post-processing (``merge_stroke_fragments``, ``refine_strokes``,
``residual_ink``), ``process_image`` and ``process_images`` with
``redecode_coverage`` and ``refine_snap`` (greedy and beam), one decode
launch per pass on the batched path, and the CLI's ``--preset real``,
``--redecode``, ``--redecode-passes`` and ``--refine``."""

import dataclasses
import json

import numpy as np
import pytest

import stroke_derenderer_tpu.utils as j_utils
from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.ops import device_partition as jdp
from stroke_derenderer_tpu.ops import strokes as jops
from stroke_derenderer_tpu.pipeline import strokes as jpipe
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.config import StrokesConfig as TStrokesConfig
from stroke_derenderer_tpu_torch.data.synthetic import rasterize_strokes
from stroke_derenderer_tpu_torch.io import write_png
from stroke_derenderer_tpu_torch.ops import device_partition as tdp
from stroke_derenderer_tpu_torch.ops import strokes as tops
from stroke_derenderer_tpu_torch.pipeline import strokes as tpipe

TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=16,
                        compute_dtype="float32")
RE1 = {"redecode_coverage": 0.9, "redecode_passes": 1}
RE3 = {"redecode_coverage": 0.9, "redecode_passes": 3}
REFINE = {"refine_snap": 3.0}
BOTH = RE3 | REFINE
BEAM = {"decode": "beam", "beam_size": 3}
POLICIES = [RE1, RE3, REFINE, BOTH, BEAM | RE3, BEAM | BOTH]
POLICY_IDS = ["redecode1", "redecode3", "refine", "both", "beam-redecode3",
              "beam-both"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    return d


def _polylines(rng, h, w, n, pts=12):
    out = []
    for _ in range(n):
        x0, y0 = rng.uniform(5, w - 5), rng.uniform(5, h - 5)
        step = rng.normal(0, 4, (pts, 2)).cumsum(0)
        out.append((np.clip(x0 + step[:, 0], 0, w - 1),
                    np.clip(y0 + step[:, 1], 0, h - 1)))
    return out


def _masks(seed=0):
    """Ink that a tiny random decoder leaves mostly uncovered: thick random
    walks, a glyph-less mask, masks of other heights and widths."""
    rng = np.random.default_rng(seed)
    shapes = [(128, 250, 5), (128, 90, 0), (96, 220, 3), (64, 150, 2)]
    return [rasterize_strokes(_polylines(rng, h, w, n), (h, w),
                              thickness=3).astype(bool) if n else
            np.zeros((h, w), bool) for h, w, n in shapes]


def _same_strokes(a, b):
    assert len(a) == len(b)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_config_fields_match_jax():
    j, t = StrokesConfig(), TStrokesConfig()
    for name in ("redecode_coverage", "redecode_tol", "redecode_passes",
                 "redecode_join_tol", "refine_snap"):
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("tol", [0.5, 4.0, 20.0, 60.0])
def test_merge_stroke_fragments_matches_jax(tol):
    rng = np.random.default_rng(int(tol * 10))
    strokes = _polylines(rng, 128, 400, 9, pts=6)
    # A stroke with its endpoints on another's, an empty one, a point, and
    # two pairs at the same distance (the tie rule picks the last).
    strokes.append((strokes[0][0][::-1] + 1.0, strokes[0][1][::-1]))
    strokes.append((np.zeros(0), np.zeros(0)))
    strokes.append((np.array([10.0]), np.array([10.0])))
    strokes += [(np.array([50.0, 60.0]), np.array([5.0, 5.0])),
                (np.array([63.0, 70.0]), np.array([5.0, 5.0])),
                (np.array([73.0, 80.0]), np.array([5.0, 5.0]))]
    got = tops.merge_stroke_fragments(strokes, tol)
    _same_strokes(got, jops.merge_stroke_fragments(strokes, tol))
    assert tops.merge_stroke_fragments([], tol) == []


@pytest.mark.parametrize("densify", [0.0, 2.0])
@pytest.mark.parametrize("max_shift", [3.0, 12.0])
def test_refine_strokes_matches_jax(densify, max_shift):
    rng = np.random.default_rng(7)
    truth = _polylines(rng, 128, 300, 4)
    mask = rasterize_strokes(truth, (128, 300), thickness=3)
    drifted = [(x + rng.normal(0, 2.5, x.shape), y + rng.normal(0, 2.5,
                                                                y.shape))
               for x, y in truth] + [(np.array([5.0]), np.array([5.0])),
                                     (np.array([150.0, 150.0]),
                                      np.array([60.0, 60.0]))]
    got = tops.refine_strokes(drifted, mask, max_shift, densify)
    _same_strokes(got, jops.refine_strokes(drifted, mask, max_shift,
                                           densify))
    assert tops.refine_strokes(drifted, np.zeros((128, 300))) is drifted
    assert tops.refine_strokes([], mask) == []


@pytest.mark.parametrize("tol", [1, 2, 4])
def test_residual_ink_matches_jax(tol):
    rng = np.random.default_rng(tol)
    truth = _polylines(rng, 128, 300, 6)
    mask = rasterize_strokes(truth, (128, 300), thickness=3).astype(bool)
    for pred in (truth[:3], [], truth):
        got = tpipe.residual_ink(mask, pred, tol=tol)
        want = jpipe.residual_ink(mask, pred, tol=tol)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want)
    assert tpipe.residual_ink(np.zeros((20, 30), bool), truth) is None


def test_plans_of_bool_and_uint8_masks_agree():
    """Residual masks are bool; the partition plan takes them as uint8."""
    for mask in _masks()[::2]:
        for m in (mask, mask.astype(np.uint8)):
            t = tdp.plan_partitions(m, 2, 224)
            j = jdp.plan_partitions(m, 2, 224)
            np.testing.assert_array_equal(t.gid_img, j.gid_img)
            for k in tdp.PartitionPlan.COORD_KEYS:
                np.testing.assert_array_equal(getattr(t, k), getattr(j, k))


@pytest.fixture(scope="module")
def jax_estimators(models):
    """One JAX estimator per decode mode: the residual passes and the
    refinement run on the host, so a policy only swaps its config and the
    compiled device programs are reused."""
    return {mode: j_cli.initialize_sessions(
        models, se_overrides={"decode": mode, "beam_size": 3})[1]
        for mode in ("greedy", "beam")}


@pytest.mark.parametrize("overrides", POLICIES, ids=POLICY_IDS)
def test_process_image_and_images_match_jax(models, jax_estimators,
                                            overrides):
    masks = _masks()
    je = jax_estimators[overrides.get("decode", "greedy")]
    je.config = dataclasses.replace(StrokesConfig.from_json(
        models / "configs_strokes.json"), **({"beam_size": 3} | overrides))
    _, te = cli.initialize_sessions(models, device="cpu",
                                    se_overrides=overrides)
    batched = te.process_images(masks)
    want_batched = je.process_images(masks)
    assert sum(len(s) for s in batched) > 0
    for m, b, wb in zip(masks, batched, want_batched):
        got = te.process_image(m)
        _same_strokes(got, je.process_image(m))
        _same_strokes(b, wb)
        _same_strokes(b, got)


def test_residual_passes_add_strokes(models):
    """On these masks the tiny decoder leaves ink uncovered, so the passes
    run and add points to what one pass finds."""
    masks = _masks()
    _, base = cli.initialize_sessions(models, device="cpu")
    _, re3 = cli.initialize_sessions(models, device="cpu", se_overrides=RE3)
    one = base.process_images(masks)
    more = re3.process_images(masks)
    points = lambda out: sum(x.size for s in out for x, _ in s)
    assert points(more) > points(one)
    for m, s in zip(masks, one):
        if m.any():
            assert re3._residual_for(m, s) is not None


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_process_images_decodes_once_per_pass(models, monkeypatch, passes,
                                              decode):
    """Each pass of ``process_images`` is one decode call for every image
    still in the loop; the per-image path takes one call per image and
    pass."""
    overrides = {"redecode_coverage": 0.9, "redecode_passes": passes}
    if decode == "beam":
        overrides |= BEAM
    _, te = cli.initialize_sessions(models, device="cpu",
                                    se_overrides=overrides)
    name = ("fused_beam_decode" if decode == "beam"
            else "fused_greedy_decode")
    calls, gathers = [], []
    real = getattr(tpipe, name)
    monkeypatch.setattr(tpipe, name, lambda dec, seq, *a: calls.append(
        seq.shape[0]) or real(dec, seq, *a))
    once = te._process_images_once
    monkeypatch.setattr(te, "_process_images_once", lambda imgs, ml: (
        gathers.append(len(imgs)) or once(imgs, ml)))
    masks = _masks()
    te.process_images(masks)
    assert len(calls) == len(gathers) >= 2
    assert len(gathers) <= 1 + passes
    assert gathers[0] == len(masks)
    assert all(a >= b for a, b in zip(gathers, gathers[1:]))


def _write_inputs(d):
    d.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(64, 300), (50, 123)]):
        img = np.full((h, w, 3), 255, np.uint8)
        for x, y in _polylines(rng, h, w, 4):
            xi = np.clip(np.round(x).astype(int), 0, w - 2)
            yi = np.clip(np.round(y).astype(int), 0, h - 2)
            img[yi, xi] = img[yi + 1, xi] = img[yi, xi + 1] = 20
        write_png(d / f"line{i}.png", img)


@pytest.mark.parametrize("flags", [
    ["--preset", "real"],
    ["--redecode", "0.9", "--redecode-passes", "2"],
    ["--preset", "real", "--redecode", "0"],
    ["--preset", "real", "--redecode-passes", "1", "--refine", "3"],
    ["--preset", "real", "--batch"],
    ["--preset", "real", "--decode", "beam", "--beam-size", "3"],
], ids=["preset", "redecode", "preset-off", "preset-passes-refine",
        "preset-batch", "preset-beam"])
def test_cli_flags_write_what_the_jax_cli_writes(models, tmp_path,
                                                 monkeypatch, capsys, flags):
    monkeypatch.setattr(j_utils, "enable_compile_cache", lambda *a: None)
    monkeypatch.setattr(j_utils, "honor_platform_env", lambda: None)
    _write_inputs(tmp_path / "in")
    common = ["-models", str(models), "-input", str(tmp_path / "in")]
    assert cli.entrypoint(common + ["--output", str(tmp_path / "t"),
                                    "--device", "cpu"] + flags) == 0
    assert j_cli.entrypoint(common + ["--output", str(tmp_path / "j")]
                            + flags) == 0
    assert "[error]" not in capsys.readouterr().out
    for i in range(2):
        name = f"line{i}_STROKES.json"
        got = json.loads((tmp_path / "t" / name).read_text())
        assert got == json.loads((tmp_path / "j" / name).read_text()), name


def test_preset_and_flag_precedence():
    def ov(argv):
        return cli.strokes_overrides(cli.parse_args(["-models", "m"] + argv))

    assert ov([]) == {}
    assert ov(["--preset", "real"]) == {"redecode_coverage": 0.9}
    assert ov(["--preset", "real", "--redecode", "0.5"]) == {
        "redecode_coverage": 0.5}
    assert ov(["--preset", "reference", "--refine", "2",
               "--redecode-passes", "4"]) == {"refine_snap": 2.0,
                                              "redecode_passes": 4}

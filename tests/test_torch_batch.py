"""The port's cross-image batched path against the JAX package's and against
its own per-image path, on a tiny float32 model and numpy-seeded inputs:
``gather_crops_batched``, ``process_images`` (greedy and beam), the CLI's
``--batch``, ``--no-strokes``, ``--svg`` and ``--fused``, and the PNG bytes
codec the server uses."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.io import strokes_to_svg as j_strokes_to_svg
from stroke_derenderer_tpu.ops import device_partition as jdp
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.io import (
    decode_png, encode_png, read_png, strokes_to_svg, write_png,
)
from stroke_derenderer_tpu_torch.ops import device_partition as tdp

REPO = Path(__file__).resolve().parent.parent
TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=24,
                        compute_dtype="float32")
BEAM = {"decode": "beam", "beam_size": 3}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    return d


def _line(rng, h, w, gray=True):
    """A white line image with dark bars; ``gray=False`` adds colour noise
    to one channel."""
    img = np.full((h, w, 3), 255, np.uint8)
    for _ in range(6):
        y, x = rng.integers(5, h - 15), rng.integers(0, w - 40)
        img[y:y + rng.integers(3, 12), x:x + rng.integers(5, 40)] = \
            rng.integers(0, 80)
    if not gray:
        noise = rng.integers(-20, 20, img.shape[:2])
        img[..., 1] = np.clip(img[..., 1].astype(int) + noise, 0, 255)
    return img


def _images(seed=0):
    """Three lines of one tile plan (one of them coloured), then ragged
    widths: one at the model height, one coloured that spans many tiles,
    resized widths of 401 and 314 (not multiples of 8)."""
    rng = np.random.default_rng(seed)
    return [_line(rng, 64, 300), _line(rng, 64, 300),
            _line(rng, 64, 300, gray=False), _line(rng, 128, 500),
            _line(rng, 96, 301), _line(rng, 128, 1000, gray=False),
            _line(rng, 50, 123)]


def _mask(rng, h, w, n):
    """n loops of a few pixels' ink at random places."""
    m = np.zeros((h, w), bool)
    t = np.linspace(0, 2 * np.pi, 200)
    for _ in range(n):
        cx, cy = rng.integers(20, w - 20), rng.integers(20, h - 20)
        r = rng.integers(5, 18)
        xs = (cx + r * np.cos(t * rng.uniform(0.5, 2))).astype(int)
        ys = (cy + r * np.sin(t)).astype(int)
        m[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = True
    return m


def _masks(seed=1):
    """Glyph-less masks between others, and masks of other heights and
    widths."""
    rng = np.random.default_rng(seed)
    return [_mask(rng, 128, 400, 5), np.zeros((128, 200), bool),
            _mask(rng, 128, 333, 3), _mask(rng, 64, 250, 4),
            np.zeros((128, 50), bool), _mask(rng, 128, 520, 7)]


def _same_strokes(a, b):
    assert len(a) == len(b)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def _gather_case(seed=2):
    masks = [m for m in _masks(seed) if m.any()]
    plans = [tdp.plan_partitions(m, 2, 224) for m in masks]
    h = max(m.shape[0] for m in masks)
    w = max(m.shape[1] for m in masks)
    stack = np.full((len(masks), h, w), -1, np.int16)
    for i, (m, p) in enumerate(zip(masks, plans)):
        stack[i, :m.shape[0], :m.shape[1]] = p.gid_img
    img_idx = np.concatenate([np.full(len(p.partitions), i, np.int32)
                              for i, p in enumerate(plans)])
    local_id = np.concatenate([np.arange(len(p.partitions), dtype=np.int32)
                               for p in plans])
    perm = np.random.default_rng(seed).permutation(len(img_idx))
    coords = [np.concatenate([getattr(p, k) for p in plans])[perm]
              for k in tdp.PartitionPlan.COORD_KEYS]
    return plans, stack, img_idx[perm], local_id[perm], coords, perm


@pytest.mark.parametrize("seed", [2, 3])
def test_gather_crops_batched_matches_jax_and_per_image(seed):
    """The batched crops are the port's per-image crops, row for row,
    exactly. Against the JAX crops the bar of ``test_torch_ops.py``'s
    ``gather_crops`` holds: each crop texel is a float32 sum of products
    rounded to an integer, the two packages' products fuse their
    multiply-adds differently, so a texel at an exact half can round the
    other way (by 1). The JAX package's own batched and per-image crops
    differ so on this input."""
    plans, stack, img_idx, local_id, coords, perm = _gather_case(seed)
    got = tdp.gather_crops_batched(
        torch.from_numpy(stack), torch.from_numpy(img_idx),
        torch.from_numpy(local_id), tuple(torch.from_numpy(c)
                                          for c in coords)).numpy()
    want = np.asarray(jdp.gather_crops_batched(
        jnp.asarray(stack), jnp.asarray(img_idx), jnp.asarray(local_id),
        tuple(jnp.asarray(c) for c in coords), "i16"))
    assert got.shape == want.shape == (len(img_idx), 224, 224)
    assert (got == want).mean() >= 0.999
    assert np.abs(got - want).max() <= 1.0
    per_image = np.concatenate([tdp.gather_crops(
        torch.from_numpy(p.gid_img),
        tuple(torch.from_numpy(np.ascontiguousarray(getattr(p, k)))
              for k in tdp.PartitionPlan.COORD_KEYS)).numpy()
        for p in plans])
    np.testing.assert_array_equal(got, per_image[perm])


@pytest.mark.parametrize("overrides", [None, {"io_chunks": 2}, BEAM,
                                       dict(BEAM, io_chunks=2)])
def test_process_images_matches_jax_and_per_image(models, overrides):
    masks = _masks()
    _, je = j_cli.initialize_sessions(models, se_overrides=overrides)
    _, te = cli.initialize_sessions(models, device="cpu",
                                    se_overrides=overrides)
    want = je.process_images(masks)
    got = te.process_images(masks)
    assert len(got) == len(masks)
    assert [len(s) for s in got] == [len(s) for s in want]
    assert sum(len(s) for s in got) > 0
    for m, g, w in zip(masks, got, want):
        _same_strokes(g, w)
        _same_strokes(g, te.process_image(m))
        if not m.any():
            assert g == []


def test_process_images_of_no_glyphs(models, monkeypatch):
    _, te = cli.initialize_sessions(models, device="cpu")
    monkeypatch.setattr(te, "_encode_and_decode", lambda *a: pytest.fail(
        "decoded an empty batch"))
    assert te.process_images([np.zeros((128, 90), bool)] * 3) == [[]] * 3
    assert te.process_images([]) == []


def test_ink_order_is_undone(models, monkeypatch):
    """The glyph rows go to the device by decreasing ink, which here is not
    their order; one decode call takes them all, and ``inv`` gives each
    image its own rows back: a decode that writes each row's crop ink as
    its tokens yields the per-image tokens."""
    _, te = cli.initialize_sessions(models, device="cpu")
    masks = _masks()
    seen = []

    def ink_tokens(crops, max_length):
        seen.append(crops.shape[0])
        ink = (crops > 127).sum((1, 2)).int()
        return torch.stack([torch.full_like(ink, 1), ink % 400 + 3,
                            ink // 400 + 3, torch.full_like(ink, 2)], 1)

    monkeypatch.setattr(te, "_encode_and_decode", ink_tokens)
    tokens = []
    monkeypatch.setattr(te, "process_tokens",
                        lambda t, parts: tokens.append(t.copy()) or [])
    te.process_images(masks)
    batched = tokens[:]
    tokens.clear()
    for m in masks:
        te.process_image(m)
    per_image = [t for t in tokens if len(t)]
    assert seen[0] == sum(len(t) for t in per_image)  # one call for all
    assert len(batched) == len(per_image)
    for b, p in zip(batched, per_image):
        np.testing.assert_array_equal(b, p)
    # The permutation is not the identity on this batch.
    plans = [tdp.plan_partitions(m, 2, 224) for m in masks]
    ink = np.concatenate([p.ink for p in plans if p is not None])
    assert not np.array_equal(np.argsort(-ink, kind="stable"),
                              np.arange(len(ink)))


def _write_inputs(d):
    d.mkdir()
    for i, img in enumerate(_images(3)):
        write_png(d / f"line{i}.png", img)
    write_png(d / "blank.png", np.full((40, 90, 3), 255, np.uint8))


@pytest.mark.parametrize("fused", [False, True])
def test_batch_flag_writes_what_the_per_image_run_writes(models, tmp_path,
                                                         capsys, fused):
    _write_inputs(tmp_path / "in")
    common = ["-models", str(models), "-input", str(tmp_path / "in"),
              "--device", "cpu", "--svg"] + (["--fused"] if fused else [])
    assert cli.entrypoint(common + ["--output", str(tmp_path / "a")]) == 0
    assert cli.entrypoint(common + ["--output", str(tmp_path / "b"),
                                    "--batch"]) == 0
    out = capsys.readouterr().out
    assert "(amortized)" in out and "[error]" not in out
    files = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "b").iterdir())
    assert len(files) == 3 * 8
    for name in files:
        assert ((tmp_path / "a" / name).read_bytes()
                == (tmp_path / "b" / name).read_bytes()), name


def test_no_strokes_and_svg(models, tmp_path):
    _write_inputs(tmp_path / "in")
    base = ["-models", str(models), "-input", str(tmp_path / "in"),
            "--device", "cpu"]
    for extra in ([], ["--batch"]):
        out = tmp_path / f"out{len(extra)}"
        assert cli.entrypoint(base + ["--output", str(out), "--no-strokes"]
                              + extra) == 0
        names = {p.name for p in out.iterdir()}
        assert len(names) == 8
        assert all(n.endswith("_BINARIZED.png") for n in names)
    out = tmp_path / "svg"
    assert cli.entrypoint(base + ["--output", str(out), "--svg"]) == 0
    img = read_png(tmp_path / "in" / "line5.png")
    strokes = json.loads((out / "line5_STROKES.json").read_text())
    svg = (out / "line5_STROKES.svg").read_text()
    assert svg.startswith("<svg") and f'viewBox="0 0 {img.shape[1]} ' \
        f'{img.shape[0]}"' in svg
    assert svg.count("<polyline") + svg.count("<circle") == len(strokes)


def test_strokes_to_svg_matches_jax():
    rng = np.random.default_rng(4)
    strokes = [(rng.uniform(0, 300, n), rng.uniform(0, 90, n))
               for n in (5, 1, 0, 12)]
    strokes.append((np.arange(3.0), np.arange(4.0)))  # ragged: trimmed
    for kwargs in ({}, {"size": (640, 128)}, {"scale": 0.37},
                   {"stroke_width": 3.5, "color": "#c00"}):
        assert strokes_to_svg(strokes, **kwargs) == j_strokes_to_svg(
            strokes, **kwargs)
    assert strokes_to_svg([]) == j_strokes_to_svg([])


@pytest.mark.parametrize("shape", [(7, 13), (7, 13, 1), (9, 5, 3)])
def test_png_bytes_round_trip(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, np.uint8)
    data = encode_png(img)
    got = decode_png(data)
    np.testing.assert_array_equal(got, img.reshape(shape[:2] + (-1,)))
    write_png(tmp_path / "x.png", img)
    assert (tmp_path / "x.png").read_bytes() == data
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), got)


def test_png_bytes_decode_like_files():
    for p in [REPO / "tests" / "golden" / "golden_input.png",
              REPO / "tests" / "golden" / "expected_BINARIZED.png",
              *sorted((REPO / "data_pseudo_real").glob("*.png"))[:4]]:
        np.testing.assert_array_equal(decode_png(p.read_bytes()),
                                      read_png(p))


@pytest.mark.parametrize("blob", [b"", b"garbage not a png",
                                  b"\x89PNG\r\n\x1a\n\x00\x00",
                                  encode_png(np.zeros((4, 4), np.uint8))[:40],
                                  encode_png(np.zeros((4, 4), np.uint8))[:-20]])
def test_bad_png_bytes_raise_value_error(blob):
    with pytest.raises(ValueError):
        decode_png(blob)


def test_config_fields_of_the_batched_path():
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig as TBin, StrokesConfig as TSe,
    )
    for t, j, names in ((TBin, BinarizerConfig, ("fused_batch_min",
                                                 "io_chunks")),
                        (TSe, StrokesConfig, ("io_chunks",))):
        for name in names:
            assert getattr(t(), name) == getattr(j(), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_networks_give_a_row_the_same_output_in_any_batch(dtype):
    """The shipped UNet and encoder compute a row the same whatever batch it
    rides in, up to the last bits of a convolution whose algorithm the CPU
    library picks by batch size. GroupNorm on a channels-last tensor split
    its sums by the batch size on the CPU, and both networks had one after
    their first convolution: a row then moved by 7e-6 (float32) to 0.02
    (bfloat16) in the UNet's probabilities and up to 0.25 in the bfloat16
    encoder's features, over most of the row; now at most a few outputs in
    ten thousand move, by less than 1e-8 here."""
    tb, te = cli.initialize_sessions(
        REPO / "models_demo", device="cpu",
        bin_overrides={"compute_dtype": dtype},
        se_overrides={"compute_dtype": dtype})
    rng = np.random.default_rng(9)
    tiles = torch.from_numpy(rng.uniform(size=(8, 128, 384, 3)).astype(
        np.float32))
    crops = torch.from_numpy(rng.normal(size=(8, 224, 224, 3)).astype(
        np.float32))
    with torch.inference_mode():
        for net, x in ((tb.model, tiles), (te.encoder, crops)):
            full = net(x)
            for rows in (slice(0, 1), slice(2, 5), slice(3, 8)):
                diff = (net(x[rows]) - full[rows]).abs()
                assert float(diff.max()) <= 1e-6
                assert float((diff > 0).float().mean()) <= 1e-3

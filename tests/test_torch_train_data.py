"""The port's training data against the JAX package's: the synthetic
generators and the letterform lines (the same samples and the same
generator state after every call), the real-data pools, the glyph cache
(built by either package, read by the other), the prefetch loader, and the
host partition (``sort_islands``, ``group_islands``,
``compute_partitions``) with the CLI's ``--host-partition`` path."""

from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu.config import StrokesConfig
from stroke_derenderer_tpu.data import cache as jcache
from stroke_derenderer_tpu.data import letters as jlet
from stroke_derenderer_tpu.data import loader as jloader
from stroke_derenderer_tpu.data import real as jreal
from stroke_derenderer_tpu.data import synthetic as jsyn
from stroke_derenderer_tpu.ops import grouping as jgrp
from stroke_derenderer_tpu.pipeline import strokes as jstrokes
from stroke_derenderer_tpu.pipeline.strokes import (
    StrokeEstimator as JStrokeEstimator,
)
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import (
    BinarizerConfig as TBinarizerConfig, StrokesConfig as TStrokesConfig,
)
from stroke_derenderer_tpu_torch.data import cache as tcache
from stroke_derenderer_tpu_torch.data import letters as tlet
from stroke_derenderer_tpu_torch.data import loader as tloader
from stroke_derenderer_tpu_torch.data import real as treal
from stroke_derenderer_tpu_torch.data import synthetic as tsyn
from stroke_derenderer_tpu_torch.io import load_image
from stroke_derenderer_tpu_torch.ops import grouping as tgrp
from stroke_derenderer_tpu_torch.pipeline import strokes as tstrokes
from stroke_derenderer_tpu_torch.pipeline.strokes import StrokeEstimator

REPO = Path(__file__).resolve().parent.parent
REAL = REPO / "examples" / "real_data"
GOLDEN = REPO / "tests" / "golden"


def _same(a, b):
    """Equal structure and values: arrays by dtype, shape and content."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b


def _both(fn_t, fn_j, seed, *args, **kw):
    """Call both with generators from one seed: equal outputs and equal
    generator states afterwards."""
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = fn_t(rt, *args, **kw), fn_j(rj, *args, **kw)
    _same(got, want)
    assert rt.bit_generator.state == rj.bit_generator.state
    return got


# --------------------------------------------------------- generators

@pytest.mark.parametrize("seed", range(4))
def test_fragment_strokes_and_tokens(seed):
    strokes = jsyn.mixed_strokes(np.random.default_rng(seed), (100, 300))
    _both(tsyn.fragment_strokes, jsyn.fragment_strokes, seed, strokes,
          cut_prob=0.9, max_cuts=3)
    for max_length in (8, 40, 400):
        _same(tsyn.tokens_from_strokes(strokes, 224, max_length),
              jsyn.tokens_from_strokes(strokes, 224, max_length))
    _same(tsyn.tokens_from_strokes([], 224, 5),
          jsyn.tokens_from_strokes([], 224, 5))


@pytest.mark.parametrize("style", ["mixed", "hand", "letters", "smooth"])
def test_line_and_glyph_samples(style):
    for seed in range(3):
        _both(tsyn.make_line_sample, jsyn.make_line_sample, seed, 128, 384,
              n_strokes=5, style=style, ruled=0.5)
        _both(tsyn.make_partitioned_glyph_sample,
              jsyn.make_partitioned_glyph_sample, seed, 97, style=style)
    _both(tsyn.make_glyph_sample, jsyn.make_glyph_sample, 5, 224, 30)
    with pytest.raises(ValueError):
        tsyn.make_partitioned_glyph_sample(np.random.default_rng(0), 8)


def test_batch_generators():
    take = lambda gen: list(gen)
    _both(lambda r, **k: take(tsyn.tile_batches(r, **k)),
          lambda r, **k: take(jsyn.tile_batches(r, **k)), 0, batch_size=3,
          n_batches=2, style="letters", ruled=0.5, narrow=0.5)
    _both(lambda r, **k: take(tsyn.partitioned_glyph_batches(r, **k)),
          lambda r, **k: take(jsyn.partitioned_glyph_batches(r, **k)), 1,
          batch_size=3, seq_len=24, n_batches=2, style="hand")
    _both(lambda r, **k: take(tsyn.glyph_batches(r, **k)),
          lambda r, **k: take(jsyn.glyph_batches(r, **k)), 2, batch_size=2,
          seq_len=16, n_batches=2)


def test_line_of_words():
    for seed in range(6):
        _both(tlet.line_of_words, jlet.line_of_words, seed, (128, 1000))
    _both(tlet.line_of_words, jlet.line_of_words, 9, (128, 60), max_words=2)


# ---------------------------------------------------------- real pools

def _real_dir(tmp_path, n=2):
    for png, sj in jreal.discover_pairs(REAL)[:n]:
        for src in (png, sj, png.with_name(f"{png.stem}_BINARIZED.png")):
            if src.exists():
                (tmp_path / src.name).write_bytes(src.read_bytes())
    return tmp_path


def test_real_pools(tmp_path):
    d = _real_dir(tmp_path)
    cfg_j, cfg_t = StrokesConfig(), TStrokesConfig()
    for png, sj in jreal.discover_pairs(d):
        _same(treal.glyph_samples_from_pair(png, sj, cfg_t, 97),
              jreal.glyph_samples_from_pair(png, sj, cfg_j, 97))
    take = lambda gen: [next(gen) for _ in range(2)]
    _both(lambda r: take(treal.real_tile_batches(d, r, 3)),
          lambda r: take(jreal.real_tile_batches(d, r, 3)), 0)
    for raw in (False, True):
        _both(lambda r: take(treal.real_glyph_batches(
                  d, r, 3, 48, config=cfg_t, raw=raw)),
              lambda r: take(jreal.real_glyph_batches(
                  d, r, 3, 48, config=cfg_j, raw=raw)), 1)
    strokes = [(np.array([1.0, 5.0]), np.array([2.0, 9.0])),
               (np.array([300.0, 320.0]), np.array([5.0, 6.0]))]
    _same(treal._assign_strokes(strokes, (0, 0), 1.5, (3.0, 4.0), 224),
          jreal._assign_strokes(strokes, (0, 0), 1.5, (3.0, 4.0), 224))
    with pytest.raises(FileNotFoundError):
        next(treal.real_tile_batches(tmp_path / "none", np.random
                                     .default_rng(0), 1))


# --------------------------------------------------------------- cache

def test_cache_either_way(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    tcache.build_glyph_cache(a, 5, seq_len=40, style="hand", seed=3)
    jcache.build_glyph_cache(b, 5, seq_len=40, style="hand", seed=3)
    _same(tcache.load_glyph_cache(a), jcache.load_glyph_cache(b))
    _same(tcache.load_glyph_cache(b), jcache.load_glyph_cache(a))
    assert (a / "meta.json").read_text() == (b / "meta.json").read_text()
    for raw in (False, True):
        _both(lambda r: list(tcache.cached_glyph_batches(
                  b, r, 3, 32, n_batches=2, raw=raw)),
              lambda r: list(jcache.cached_glyph_batches(
                  a, r, 3, 32, n_batches=2, raw=raw)), 4)
    with pytest.raises(ValueError):
        next(tcache.cached_glyph_batches(a, np.random.default_rng(0), 1, 64))
    assert tcache._main(["--out", str(tmp_path / "cli"), "--n", "2",
                         "--seq-len", "24", "--style", "smooth"]) == 0
    assert tcache.load_glyph_cache(tmp_path / "cli")[0].shape == (2, 224,
                                                                  224)


# -------------------------------------------------------------- loader

def test_prefetch_loader():
    def make(w):
        for i in range(5):
            yield (w, i)
    assert list(tloader.PrefetchLoader(make, num_workers=1)) == [
        (0, i) for i in range(5)]
    got = list(tloader.PrefetchLoader(make, num_workers=3))
    assert sorted(got) == sorted(list(jloader.PrefetchLoader(make, 3)))

    def bad(w):
        yield 1
        raise ValueError("boom")
    with pytest.raises(RuntimeError, match="worker failed"):
        list(tloader.PrefetchLoader(bad, num_workers=1))

    def endless(w):
        while True:
            yield w
    loader = tloader.PrefetchLoader(endless, num_workers=2, prefetch=2)
    it = iter(loader)
    assert next(it) in (0, 1)
    loader.close()
    for t in loader._threads:
        t.join(timeout=5)
        assert not t.is_alive()


# ---------------------------------------------------- host partition

def _masks():
    rng = np.random.default_rng(7)
    out = []
    for w in (90, 400, 1300):
        strokes = jsyn.mixed_strokes(rng, (108, w - 20), token_budget=2000)
        strokes = [(x + 10, y + 10) for x, y in strokes]
        out.append(jsyn.rasterize_strokes(strokes, (128, w), 2))
    out.append(np.zeros((128, 50), np.uint8))
    golden = load_image(GOLDEN / "expected_BINARIZED.png")[:, :, 0] > 127
    out.append(golden.astype(np.uint8))
    return out


def test_group_islands_and_compute_partitions_match_jax():
    for mask in _masks():
        isl_t = tgrp.get_binarized_islands(mask, 2)
        isl_j = jgrp.get_binarized_islands(mask, 2)
        _same(tgrp.sort_islands(isl_t), jgrp.sort_islands(isl_j))
        _same(tgrp.group_islands(isl_t, (128, 128)),
              jgrp.group_islands(isl_j, (128, 128)))
        _same(tstrokes.compute_partitions(mask, TStrokesConfig()),
              jstrokes.compute_partitions(mask, StrokesConfig()))
    assert tstrokes.compute_partitions(np.zeros((128, 40)),
                                       TStrokesConfig()) == []


def test_host_partition_path_matches_device_path_and_jax(tmp_path):
    """On the golden mask the host crops equal the device crops; with a
    tiny float32 model the host path's strokes equal the device path's and
    the JAX package's host path's, per image and batched."""
    from stroke_derenderer_tpu.config import StrokesConfig as JS
    mask = _masks()[-1]
    cfg = TStrokesConfig()
    parts = tstrokes.compute_partitions(mask, cfg)
    plan = tstrokes.plan_partitions(mask, cfg.margin, cfg.image_size)
    coords = tuple(torch.from_numpy(np.ascontiguousarray(getattr(plan, k)))
                   for k in tstrokes.PartitionPlan.COORD_KEYS)
    dev = tstrokes.gather_crops(torch.from_numpy(plan.gid_img), coords)
    assert np.array_equal(dev.numpy(), np.stack([p["image"] for p in parts]))

    se = dict(encoder_arch="tiny", embed_dim=16, attention_dim=16,
              decoder_dim=16, max_length=16, compute_dtype="float32")
    tw.materialize_model_dir(tmp_path, TBinarizerConfig(
        features=(8,), bottleneck=16), TStrokesConfig(**se))
    paths = {"encoder": tmp_path / "strokes_encoder.msgpack",
             "decoder": tmp_path / "strokes_decoder.msgpack"}
    host = StrokeEstimator(TStrokesConfig(**se, device_partition=False),
                           paths, device="cpu")
    device = StrokeEstimator(TStrokesConfig(**se), paths, device="cpu")
    jcfg = JS(**se, device_partition=False)
    jest = JStrokeEstimator(jcfg, weights_paths={
        "encoder": paths["encoder"], "decoder": paths["decoder"]})
    masks = _masks()
    for m in masks:
        got = host.process_image(m)
        _same(got, device.process_image(m))
        _same(got, jest.process_image(m))
    _same(host.process_images(masks), [host.process_image(m) for m in masks])
    # The CLI flag.
    args = cli.parse_args(["-models", "x", "--host-partition"])
    assert cli.strokes_overrides(args)["device_partition"] is False

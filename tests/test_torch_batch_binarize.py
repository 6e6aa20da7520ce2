"""The port's batched binarization against the JAX package's and against
its own per-image path, on a tiny float32 model and numpy-seeded inputs:
the device cut and stitch, ``_prep_line``'s grey lines and every mode of
``binarize_images`` (bucketed, fused, chunked, width groups). These tests
came from ``tests/test_torch_batch.py`` unchanged, to balance the test
run's files; they share its model dir and inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.ops import tiling as jtl
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.ops import tiling as ttl
from stroke_derenderer_tpu_torch.pipeline.binarize import _prep_line
from test_torch_batch import TINY_BIN, _images, models  # noqa: F401


@pytest.mark.parametrize("width", [100, 383, 384, 385, 1137, 2900])
@pytest.mark.parametrize("c", [1, 3])
def test_device_cut_and_stitch_match_numpy_and_jax(width, c):
    rng = np.random.default_rng(width + c)
    img = rng.integers(0, 256, (2, 20, width, c), np.uint8)
    plan = ttl.plan_tiles(width, 384, 64)
    jplan = jtl.plan_tiles(width, 384, 64)
    tiles = ttl.cut_tiles(torch.from_numpy(img), plan, pad_value=7)
    assert tiles.shape == (2, plan.num_tiles, 20, 384, c)
    for i in range(2):
        want = ttl.cut_tiles_np(img[i], plan, pad_value=7)
        np.testing.assert_array_equal(tiles[i].numpy(), want)
        np.testing.assert_array_equal(
            want, np.asarray(jtl.cut_tiles(jnp.asarray(img[i]), jplan, 7)))
    masks = rng.integers(0, 256, tiles.shape, np.uint8)
    got = ttl.stitch_tiles(torch.from_numpy(masks), plan)
    assert got.dtype == torch.uint8 and got.shape == (2, 20, width, c)
    for i in range(2):
        want = ttl.stitch_tiles_np(masks[i], plan)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            want, np.asarray(jtl.stitch_tiles(jnp.asarray(masks[i]), jplan)))


def test_stitch_of_float_tiles_keeps_the_dtype():
    plan = ttl.plan_tiles(900, 384, 64)
    tiles = np.random.default_rng(0).uniform(
        size=(plan.num_tiles, 4, 384, 1)).astype(np.float32)
    got = ttl.stitch_tiles(torch.from_numpy(tiles), plan)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  ttl.stitch_tiles_np(tiles, plan))


def test_prep_line_keeps_gray_as_one_channel():
    img = _images()[0]
    one = _prep_line(img, TINY_BIN, keep_gray=True)
    three = _prep_line(img, TINY_BIN)
    assert one.shape[2] == 1 and three.shape[2] == 3
    np.testing.assert_array_equal(np.repeat(one, 3, axis=2), three)
    coloured = _images()[2]
    assert _prep_line(coloured, TINY_BIN, keep_gray=True).shape[2] == 3


@pytest.mark.parametrize("fused,io_chunks,fused_batch_min", [
    (False, 1, 3), (False, 2, 3), (True, 1, 3), (True, 2, 3), (False, 1, 0),
    (False, 1, 1)])
def test_binarize_images_matches_jax_and_per_image(models, fused, io_chunks,
                                                    fused_batch_min):
    """Every mode of the port's binarize_images gives the JAX package's
    masks exactly, and the port's per-image masks (bucketed and fused)."""
    imgs = _images()
    overrides = {"io_chunks": io_chunks, "fused_batch_min": fused_batch_min}
    jb, _ = j_cli.initialize_sessions(models, fused=fused,
                                      bin_overrides=overrides)
    tb, _ = cli.initialize_sessions(models, device="cpu", fused=fused,
                                    bin_overrides=overrides)
    assert tb.fused is fused and tb.config.io_chunks == io_chunks
    want = jb.binarize_images(imgs)
    got = tb.binarize_images(imgs)
    assert len(got) == len(imgs)
    for g, w, img in zip(got, want, imgs):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert g.shape[0] == 128 and set(np.unique(g)) <= {0, 255}
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, tb.binarize_image(img))
    # Widths not a multiple of 8 went through the bit-packing.
    assert {g.shape[1] % 8 for g in got} - {0}
    assert tb.binarize_images([]) == []


def test_binarize_images_routes_width_groups(models, monkeypatch):
    """Width groups of at least fused_batch_min images take the batched
    fused program, one call per chunk; the rest one bucketed tile batch."""
    tb, _ = cli.initialize_sessions(models, device="cpu",
                                    bin_overrides={"io_chunks": 2})
    calls = {"fused": [], "tiles": []}
    fused_batch, tiles = tb._fused_batch, tb.binarize_tiles
    monkeypatch.setattr(tb, "_fused_batch", lambda b, plan: calls[
        "fused"].append(b.shape) or fused_batch(b, plan))
    monkeypatch.setattr(tb, "binarize_tiles", lambda t: calls[
        "tiles"].append(t.shape) or tiles(t))
    tb.binarize_images(_images())
    # Three same-plan images in chunks of 2 and 1, achromatic and coloured
    # lines stacked as three channels; four ragged images in one batch.
    assert calls["fused"] == [(2, 128, 600, 1), (1, 128, 600, 3)]
    assert len(calls["tiles"]) == 1

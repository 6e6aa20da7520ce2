"""Port I/O against the JAX package's: the PNG reader against PIL, the
writer round trip, the msgpack reader against flax, and ``from_flax``
leaf for leaf."""

import struct
import zlib
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from stroke_derenderer_tpu.kernels.fused_decode import pack_decoder_weights
from stroke_derenderer_tpu_torch import io as tio
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
from stroke_derenderer_tpu_torch.models.encoder import ResNetEncoder
from stroke_derenderer_tpu_torch.models.unet import AttentionUNet

REPO = Path(__file__).resolve().parent.parent
# The folders of the repo that hold PNGs (a fixed list: parametrization must
# not depend on files that other tests may write meanwhile).
PNG_DIRS = ["data_pseudo_real", "docs", "examples/real_data",
            "examples/sample_data", "images/input", "tests/golden"]
MODELS = REPO / "models_demo"


@pytest.mark.parametrize("folder", PNG_DIRS)
def test_png_reader_matches_pil(folder):
    """Every PNG in the repo decodes to exactly what PIL's convert("RGB")
    gives (colour types 0, 2 and 6, all five row filters)."""
    paths = sorted((REPO / folder).glob("*.png"))
    assert paths
    for p in paths:
        want = np.asarray(Image.open(p).convert("RGB"))
        np.testing.assert_array_equal(tio.load_image(p), want, err_msg=str(p))


def test_png_reader_grayscale_matches_jax_io():
    from stroke_derenderer_tpu.io import load_image
    p = REPO / "tests" / "golden" / "golden_input.png"
    np.testing.assert_array_equal(tio.load_image(p, grayscale=True),
                                  load_image(str(p), grayscale=True))


def test_png_reader_palette(tmp_path):
    rng = np.random.default_rng(0)
    # More than 16 colours, so that PIL writes an 8-bit palette.
    pal = Image.fromarray(rng.integers(0, 256, (19, 23, 3), np.uint8)).convert(
        "P", palette=Image.ADAPTIVE, colors=64)
    pal.save(tmp_path / "p.png")
    want = np.asarray(Image.open(tmp_path / "p.png").convert("RGB"))
    np.testing.assert_array_equal(tio.load_image(tmp_path / "p.png"), want)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_bytes(w, h, depth, ctype, data: bytes, interlace=0, palette=None):
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def _filtered_rows(sub, depth, rng) -> bytes:
    """(h, w, c) samples -> packed rows, each behind a random filter type
    (all five occur), as a PNG encoder writes them."""
    h, w, c = sub.shape
    if depth == 16:
        rows = sub.astype(">u2").reshape(h, w * c).view(np.uint8)
    elif depth == 8:
        rows = sub.astype(np.uint8).reshape(h, w * c)
    else:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint16)
        padded[:, :w] = sub[:, :, 0]
        shifts = np.arange(8 - depth, -1, -depth)
        rows = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    bpp = max(1, depth * c // 8)
    x = rows.astype(np.int16)
    b = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    a = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    cc = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    ftype = np.arange(h) % 5
    rng.shuffle(ftype)
    out = bytearray()
    for r in range(h):
        out.append(int(ftype[r]))
        out += ((x[r] - preds[ftype[r]][r]) & 255).astype(np.uint8).tobytes()
    return bytes(out)


def _write_png(path, samples, depth, ctype, interlace=0, palette=None,
               seed=0):
    rng = np.random.default_rng(seed)
    h, w, _ = samples.shape
    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                  (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
        data = b"".join(_filtered_rows(samples[y0::dy, x0::dx], depth, rng)
                        for x0, y0, dx, dy in passes
                        if x0 < w and y0 < h)
    else:
        data = _filtered_rows(samples, depth, rng)
    path.write_bytes(_png_bytes(w, h, depth, ctype, data, interlace,
                                palette))


# (name, bit depth, colour type, samples per pixel, interlace, palette
# entries, height, width): every depth and colour type PIL reads, plain and
# Adam7-interlaced, at sizes where some interlace passes are empty.
PNG_CASES = [
    ("grey1", 1, 0, 1, 0, 0, 11, 13), ("grey2", 2, 0, 1, 0, 0, 11, 13),
    ("grey4", 4, 0, 1, 0, 0, 11, 13), ("grey16", 16, 0, 1, 0, 0, 11, 13),
    ("palette1", 1, 3, 1, 0, 2, 9, 17), ("palette2", 2, 3, 1, 0, 3, 9, 17),
    ("palette4", 4, 3, 1, 0, 16, 9, 17), ("rgb16", 16, 2, 3, 0, 0, 7, 10),
    ("rgba16", 16, 6, 4, 0, 0, 7, 10), ("grey_alpha8", 8, 4, 2, 0, 0, 7, 10),
    ("grey_alpha16", 16, 4, 2, 0, 0, 7, 10),
    ("adam7_rgb8", 8, 2, 3, 1, 0, 19, 21),
    ("adam7_grey1", 1, 0, 1, 1, 0, 19, 21),
    ("adam7_grey16", 16, 0, 1, 1, 0, 10, 12),
    ("adam7_palette4", 4, 3, 1, 1, 12, 9, 9),
    ("adam7_rgba8_tiny", 8, 6, 4, 1, 0, 3, 2),
    ("adam7_grey_alpha16", 16, 4, 2, 1, 0, 6, 5),
]


@pytest.mark.parametrize("name,depth,ctype,chans,interlace,n_pal,h,w",
                         PNG_CASES, ids=[c[0] for c in PNG_CASES])
def test_png_reader_every_format_matches_pil(tmp_path, name, depth, ctype,
                                             chans, interlace, n_pal, h, w):
    """PNGs of every bit depth and colour type, plain and Adam7, with all
    five row filters: load_image gives exactly PIL's convert("RGB"), the
    16-bit grey samples on both sides of 255 included."""
    rng = np.random.default_rng(len(name) * 31 + depth)
    # Palette indices may point past a short palette (PIL gives black).
    samples = rng.integers(0, 1 << depth, (h, w, chans))
    if depth == 16 and ctype == 0:
        samples[0, :4, 0] = (100, 255, 256, 1000)
    palette = rng.integers(0, 256, (n_pal, 3)) if ctype == 3 else None
    path = tmp_path / f"{name}.png"
    _write_png(path, samples, depth, ctype, interlace, palette)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(tio.load_image(path), want)


@pytest.mark.parametrize("mode,kwargs", [("1", {}), ("P", {"bits": 4}),
                                         ("P", {"bits": 2}), ("I;16", {}),
                                         ("LA", {})])
def test_png_reader_pil_written_low_and_high_depths(tmp_path, mode, kwargs):
    """Files PIL itself writes at 1, 2, 4 and 16 bits and as grey + alpha
    load as PIL loads them."""
    rng = np.random.default_rng(5)
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 700, (13, 9)).astype(np.uint16))
    elif mode == "P":
        img = Image.fromarray(rng.integers(0, 1 << kwargs["bits"], (13, 9))
                              .astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 48).astype(np.uint8).tobytes())
    elif mode == "LA":
        img = Image.fromarray(rng.integers(0, 256, (13, 9, 2))
                              .astype(np.uint8), "LA")
    else:
        img = Image.fromarray(rng.integers(0, 2, (13, 9)).astype(bool))
    img.save(tmp_path / "x.png", **kwargs)
    with open(tmp_path / "x.png", "rb") as f:
        header = f.read(29)
    assert header[24] == {"1": 1, "P": kwargs.get("bits"), "I;16": 16,
                          "LA": 8}[mode]
    want = np.asarray(Image.open(tmp_path / "x.png").convert("RGB"))
    np.testing.assert_array_equal(tio.load_image(tmp_path / "x.png"), want)


def test_png_reader_rejects_unsupported(tmp_path):
    """Files that are no valid PNG raise: bit depths a colour type does not
    allow, an unknown colour type or interlace method, a bad signature."""
    for name, depth, ctype, interlace in (("g3", 3, 0, 0), ("rgb4", 4, 2, 0),
                                          ("p16", 16, 3, 0), ("c5", 8, 5, 0),
                                          ("i2", 8, 0, 2)):
        (tmp_path / f"{name}.png").write_bytes(
            _png_bytes(2, 2, depth, ctype, b"\0" * 64, interlace))
        with pytest.raises(ValueError, match="unsupported PNG"):
            tio.read_png(tmp_path / f"{name}.png")
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        tio.read_png(tmp_path / "bad.png")


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 1), (9, 31, 3)])
def test_png_writer_round_trip(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    tio.save_image(img, tmp_path / "o.png", grayscale=len(shape) < 3
                   or shape[2] == 1)
    got = np.asarray(Image.open(tmp_path / "o.png"))
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    assert Image.open(tmp_path / "o.png").mode == ("RGB" if shape[-1] == 3
                                                   else "L")
    np.testing.assert_array_equal(tio.read_png(tmp_path / "o.png"),
                                  img.reshape(got.shape + (1,) * (3 - got.ndim)))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("name", ["binarizer", "strokes_encoder",
                                  "strokes_decoder"])
def test_msgpack_reader_matches_flax(name):
    path = MODELS / f"{name}.msgpack"
    got = tw.read_msgpack(path)
    want = flax.serialization.msgpack_restore(path.read_bytes())
    lg, lw = _leaves(got), _leaves(want)
    assert [k for k, _ in lg] == [k for k, _ in lw]
    for (k, a), (_, b) in zip(lg, lw):
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_from_flax_unet_leaf_for_leaf():
    tree = tw.read_msgpack(MODELS / "binarizer.msgpack")
    sd = tw.from_flax_unet(tree, 3)
    assert len(sd) == len(_leaves(tree)) == 68
    AttentionUNet((16, 32, 64), 128).load_state_dict(sd)  # strict
    p = tree["params"]
    np.testing.assert_array_equal(
        sd["down.1.conv0.weight"].numpy(),
        p["ConvBlock_1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["up.0.weight"].numpy(),
        p["ConvTranspose_0"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["up_blocks.2.norm1.weight"].numpy(),
                                  p["ConvBlock_6"]["GroupNorm_1"]["scale"])


def test_from_flax_encoder_leaf_for_leaf():
    tree = tw.read_msgpack(MODELS / "strokes_encoder.msgpack")
    sd = tw.from_flax_encoder(tree, "basic")
    assert len(sd) == len(_leaves(tree)) == 60
    ResNetEncoder("resnet18").load_state_dict(sd)  # strict
    p = tree["params"]
    np.testing.assert_array_equal(
        sd["blocks.2.proj.weight"].numpy(),
        p["BasicBlock_2"]["proj"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["blocks.2.proj_norm.bias"].numpy(),
                                  p["BasicBlock_2"]["GroupNorm_2"]["bias"])


def test_from_flax_decoder_matches_kernel_packing():
    """The decoder's state is the JAX kernel's packed layout, leaf for leaf
    (vocabulary padding aside)."""
    tree = tw.read_msgpack(MODELS / "strokes_decoder.msgpack")
    sd = tw.from_flax_decoder(tree)
    dec = AttentiveDecoder(451, 512, 512, 512, 512)
    dec.load_state_dict(sd)  # strict
    packed = {k: np.asarray(v) for k, v in
              pack_decoder_weights(tree["params"]).items()}
    w = dec.weights(torch.float32)
    for k in ("watt", "wf", "wx", "wh"):
        np.testing.assert_array_equal(w[k].numpy(), packed[k], err_msg=k)
    for k in ("batt", "bf", "blstm"):
        np.testing.assert_array_equal(w[k].numpy(), packed[k][0], err_msg=k)
    np.testing.assert_array_equal(w["v"].numpy(), packed["v"][:, 0])
    np.testing.assert_array_equal(w["bv"].numpy(), packed["bv"][0])
    np.testing.assert_array_equal(w["emb"].numpy(), packed["emb"][:451])
    np.testing.assert_array_equal(w["wfc"].numpy(), packed["wfc"][:, :451])
    np.testing.assert_array_equal(w["bfc"].numpy(), packed["bfc"][0, :451])
    p = tree["params"]
    for name in ("enc_att", "init_h", "init_c"):
        np.testing.assert_array_equal(sd[f"{name}_w"].numpy(),
                                      p[name]["kernel"])
        np.testing.assert_array_equal(sd[f"{name}_b"].numpy(), p[name]["bias"])

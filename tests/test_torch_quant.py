"""The port's dynamic int8 quantization (``ops/quant.py``) against the JAX
package's, on the same numpy inputs: the quantizer and the int8
convolution bit for bit, the Dense product and its fallback, the parameter
sets, the small int8 UNet and encoder through the weight carry-over, and
``process_image``/``process_images`` under int8, including the padding of
the encoder's batch that makes int8's per-tensor scale span the JAX
package's rows."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.models import AttentionUNet as JUNet
from stroke_derenderer_tpu.models import ResNetEncoder as JEncoder
from stroke_derenderer_tpu.ops import quant as jq
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.encoder import ResNetEncoder
from stroke_derenderer_tpu_torch.models.layers import conv
from stroke_derenderer_tpu_torch.models.unet import AttentionUNet
from stroke_derenderer_tpu_torch.ops import quant as tq
from stroke_derenderer_tpu_torch.pipeline import strokes as tstrokes

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# Masks of the small int8 UNet. The float layers between the int8 convs
# (GroupNorm, the gates) sum in other orders in the two frameworks; a
# difference of 1e-7 can move a value across an int8 rounding step, and
# where that value is a tensor's largest it moves the per-tensor scale and
# so every value of the next layer. Each block alone agrees to 2e-6 (the
# convs bit for bit, above), but through five blocks of random weights,
# whose probabilities lie within 0.1 of the threshold, the two int8 UNets
# part by as much as JAX's own int8 and float UNets do: measured over five
# seeds, mask agreement 0.9933 to 1.0 and mean |dp| up to 3.2e-3 (JAX int8
# against JAX float on this test's model: 0.9954 and 3.3e-3).
UNET_MASK_AGREE = 0.99
UNET_MEAN_DP = 5e-3
# Encoder features, float32 int8 encoder against JAX's: measured cosine
# 1 - 1.4e-5 on these inputs (the same float-order effect as the UNet's).
ENC_COSINE = 0.9999
# A greedy decode may leave JAX's only where its top-2 logit gap is this
# small (PERF.md section 2, K1's float32 bar).
F32_GAP = 1e-3
TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=32,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=24,
                        compute_dtype="float32")
INT8 = {"quant": "int8"}


def test_quantize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    # Ties: with max |x| = 127 the scale is 1, so these land on .5 exactly
    # and round half to even.
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                     3.4999998, 0.0], np.float32)
    cases = [(ties, None), (rng.normal(size=(4, 5, 6)).astype(np.float32)
                            * 7.0, None),
             (rng.normal(size=(6, 3, 3, 5)).astype(np.float32), (1, 2, 3)),
             (np.zeros((3, 4), np.float32), None),
             (rng.normal(size=(5, 7)).astype(np.float32) * 1e-3, (0,))]
    for x, dims in cases:
        jaxes = None if dims is None else dims
        qj, sj = jq._quantize(jnp.asarray(x), jaxes)
        qt, st = tq._quantize(torch.from_numpy(x), dims)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
    q, _ = tq._quantize(torch.from_numpy(ties))
    assert q[1:7].tolist() == [0, 2, 2, 0, -2, -2]


def _j_conv(x, w, b, stride, pad, jdt, groups=1):
    """flax ``nn.Conv`` with the JAX int8 injection, NHWC in and out."""
    k = w.shape[0]
    mod = fnn.Conv(w.shape[-1], (k, k), (stride, stride),
                   padding=[(pad, pad), (pad, pad)], use_bias=b is not None,
                   dtype=jdt, feature_group_count=groups,
                   conv_general_dilated=jq.int8_conv_general_dilated)
    params = {"kernel": jnp.asarray(w)}
    if b is not None:
        params["bias"] = jnp.asarray(b)
    return np.asarray(mod.apply({"params": params}, jnp.asarray(x).astype(
        jdt)).astype(jnp.float32))


# (batch, height, width, in, out, kernel, stride, pad, bias)
GEOMETRIES = {
    "3x3 s1 p1": (2, 12, 20, 16, 16, 3, 1, 1, False),
    "3x3 s2 p1": (2, 13, 11, 8, 16, 3, 2, 1, False),
    "7x7 s2 p3 stem": (2, 30, 28, 3, 8, 7, 2, 3, False),
    "1x1 bias": (2, 9, 10, 16, 8, 1, 1, 0, True),
    "1x1 s2 proj": (2, 10, 10, 8, 16, 1, 2, 0, False),
    "odd channels": (3, 9, 7, 5, 12, 3, 1, 1, True),
    "M <= 16": (1, 3, 4, 8, 8, 1, 1, 0, False),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_int8_conv_matches_jax_bit_for_bit(geometry, dtype):
    """``layers.conv(..., quant="int8")`` (weight cast to the input's dtype,
    int8 contraction, bias added in that dtype) against a flax ``Conv``
    with the JAX injection."""
    b, h, w, cin, cout, k, s, p, bias = GEOMETRIES[geometry]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    kern = (rng.normal(size=(k, k, cin, cout)) * 0.2).astype(np.float32)
    bvec = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    want = _j_conv(x, kern, bvec, s, p, jdt)
    layer = torch.nn.Conv2d(cin, cout, k, s, p, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kern).permute(3, 2, 0, 1))
        if bias:
            layer.bias.copy_(torch.from_numpy(bvec))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt), layer,
                   s, p, quant="int8")
    assert got.dtype == tdt and got.is_contiguous()
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_int8_conv_matches_jax(dtype):
    """A grouped convolution, as ``test_quant.py`` takes one (no model has
    one): the int32 sums per group, bit for bit."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    kern = rng.normal(size=(3, 3, 4, 12)).astype(np.float32)
    want = _j_conv(x, kern, None, 2, 1, jdt, groups=2)
    got = tq.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt),
                         torch.from_numpy(kern).permute(3, 2, 0, 1).to(tdt),
                         2, 1, groups=2)
    assert got.shape == (2, 12, 8, 8)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  want)


def test_int_mm_pads_to_the_cards_limits():
    """Shapes below ``torch._int_mm``'s limits on the card (M <= 16, K and
    N not multiples of 8) give the exact int32 product."""
    rng = np.random.default_rng(3)
    for m, k, n in ((1, 5, 3), (16, 8, 8), (17, 9, 13), (40, 147, 64)):
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        got = tq.int_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(),
                                      a.astype(np.int64) @ b.astype(np.int64))


def test_int8_linear_matches_jax_dense_pattern():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) * 0.2).astype(np.float32)
    want = np.asarray(jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w),
                                          (((1,), (0,)), ((), ()))))
    got = tq.int8_linear(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    x3 = rng.normal(size=(2, 3, 32)).astype(np.float32)
    want3 = np.asarray(jq.int8_dot_general(jnp.asarray(x3), jnp.asarray(w),
                                           (((2,), (0,)), ((), ()))))
    np.testing.assert_array_equal(
        tq.int8_linear(torch.from_numpy(x3), torch.from_numpy(w)).numpy(),
        want3)


def test_int8_linear_falls_back_on_other_patterns():
    """A batched product is not the Dense pattern: the float product, as
    the JAX function falls back to ``lax.dot_general``."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 4, 8)).astype(np.float32)
    b = rng.normal(size=(2, 8, 3)).astype(np.float32)
    got = tq.int8_linear(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), torch.matmul(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy())
    want = np.asarray(jq.int8_dot_general(jnp.asarray(a), jnp.asarray(b),
                                          (((2,), (1,)), ((0,), (0,)))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_injections_of_each_mode():
    for off in (None, "", "none"):
        assert tq.conv_injection(off) is None
        assert tq.dot_injection(off) is None
    assert tq.conv_injection("int8") is tq.int8_conv2d
    assert tq.dot_injection("int8") is tq.int8_linear
    for inject in (tq.conv_injection, tq.dot_injection):
        with pytest.raises(ValueError, match="unknown quant mode"):
            inject("int4")


def test_quant_state_dicts_identical():
    """The parameters do not depend on the mode: any checkpoint loads into
    either (the counterpart of the JAX package's param-tree test)."""
    for make in (lambda q: AttentionUNet((8, 16), 32, quant=q),
                 lambda q: ResNetEncoder("tiny", quant=q)):
        a, b = make("none").state_dict(), make("int8").state_dict()
        assert list(a) == list(b)
        assert [(v.shape, v.dtype) for v in a.values()] == \
               [(v.shape, v.dtype) for v in b.values()]


def _jitter(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * scale, tree)


def test_small_int8_unet_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(3, 32, 48, 3)).astype(np.float32)
    ju = JUNet(features=(8, 16), bottleneck=32, dtype=jnp.float32,
               quant="int8")
    v = _jitter(ju.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, 0.05)
    want = np.asarray(ju.apply(v, jnp.asarray(x)))
    tu = AttentionUNet((8, 16), 32, dtype=torch.float32, quant="int8")
    tu.load_state_dict(tw.from_flax_unet(v, 2))
    float_unet = AttentionUNet((8, 16), 32, dtype=torch.float32)
    float_unet.load_state_dict(tw.from_flax_unet(v, 2))
    with torch.no_grad():
        got = tu(torch.from_numpy(x)).numpy()
        ref = float_unet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert float(((got > 0.5) == (want > 0.5)).mean()) >= UNET_MASK_AGREE
    assert float(np.abs(got - want).mean()) <= UNET_MEAN_DP
    # int8 moved the probabilities: the path really quantized.
    assert float(np.abs(got - ref).max()) > 1e-4


def test_tiny_int8_encoder_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 224, 224, 3)).astype(np.float32)
    je = JEncoder(arch="tiny", dtype=jnp.float32, quant="int8")
    v = _jitter(je.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng, 0.05)
    want = np.asarray(je.apply(v, jnp.asarray(x))).ravel()
    te = ResNetEncoder("tiny", dtype=torch.float32, quant="int8")
    te.load_state_dict(tw.from_flax_encoder(v, "basic"))
    with torch.no_grad():
        got = te(torch.from_numpy(x)).numpy().ravel()
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= ENC_COSINE, cos


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    return d


def _glyph_mask(n, seed=6):
    """n separate loops on a 128-high line, one glyph each."""
    rng = np.random.default_rng(seed)
    m = np.zeros((128, 90 * n), bool)
    t = np.linspace(0, 2 * np.pi, 200)
    for i in range(n):
        cx, cy, r = 45 + 90 * i, 64, rng.integers(12, 30)
        xs = (cx + r * np.cos(t * rng.uniform(0.5, 2))).astype(int)
        ys = (cy + r * np.sin(t)).astype(int)
        m[ys, xs] = True
    return m


def _capture_tokens(est, monkeypatch):
    """The token matrix each ``process_tokens`` call of ``est`` sees."""
    seen = []
    orig = est.process_tokens

    def record(tokens, partitions):
        seen.append(np.asarray(tokens)[:len(partitions)].astype(np.int64))
        return orig(tokens, partitions)

    monkeypatch.setattr(est, "process_tokens", record)
    return seen


def _capture_seqs(monkeypatch):
    """The encoder sequence of every K1 call of the port's pipeline."""
    seqs = []
    orig = tstrokes.fused_greedy_decode
    monkeypatch.setattr(tstrokes, "fused_greedy_decode", lambda d, s, n: (
        seqs.append(s) or orig(d, s, n)))
    return seqs


def _assert_tokens_as_jax(decoder, got, want, seqs):
    """Each token matrix as JAX's, or apart only where the port's own top-2
    logit gap (the plain K1 on the same sequence) at the first differing
    step is below ``F32_GAP``."""
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w, enc in zip(got, want, seqs):
        if np.array_equal(g, w):
            continue
        h, c = decoder.init_state(enc)
        _, gaps = fd.fused_greedy_decode_plain(
            enc, decoder.project_encoding(enc), h, c,
            decoder.weights(enc.dtype), g.shape[1], return_gaps=True)
        gaps = gaps.numpy()
        for r in range(g.shape[0]):
            diff = np.nonzero(g[r] != w[r])[0]
            if len(diff):
                assert gaps[r, diff[0]] < F32_GAP


@pytest.mark.parametrize("host_partition", [False, True])
def test_process_image_int8_matches_jax(models, monkeypatch,
                                        host_partition):
    """Three glyphs, glyph_bucket 8, float32: tokens identical to JAX's, or
    apart only where the port's own top-2 logit gap at the first
    difference is below ``F32_GAP``."""
    ov = dict(INT8, glyph_bucket=8, device_partition=not host_partition)
    _, je = j_cli.initialize_sessions(models, se_overrides=ov)
    _, te = cli.initialize_sessions(models, device="cpu", se_overrides=ov)
    mask = _glyph_mask(3)
    want_tok, got_tok = (_capture_tokens(je, monkeypatch),
                         _capture_tokens(te, monkeypatch))
    seqs = _capture_seqs(monkeypatch)
    je.process_image(mask)
    te.process_image(mask)
    assert len(got_tok) == 1
    assert got_tok[0].shape == (3, TINY_SE.max_length)
    _assert_tokens_as_jax(te.decoder, got_tok, want_tok, seqs)


def test_int8_encoder_sees_the_jax_padded_batch(models, monkeypatch):
    """Under int8 every quantized conv of the encoder sees the glyph batch
    padded to glyph_bucket (8 rows for 3 glyphs), as JAX's does; without
    int8 the port runs the 3 real rows."""
    mask = _glyph_mask(3)
    ov = dict(INT8, glyph_bucket=8)
    _, je = j_cli.initialize_sessions(models, se_overrides=ov)
    _, te = cli.initialize_sessions(models, device="cpu", se_overrides=ov)
    # Patched after the sessions are built, so that the JAX package's
    # template traces (batch 1) are not counted; its program is traced at
    # its first call, below.
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jq.int8_conv_general_dilated, tq.int8_conv2d
    monkeypatch.setattr(jq, "int8_conv_general_dilated", lambda x, *a, **k: (
        seen["jax"].append(x.shape[0]) or j_orig(x, *a, **k)))
    monkeypatch.setattr(tq, "int8_conv2d", lambda x, *a, **k: (
        seen["port"].append(x.shape[0]) or t_orig(x, *a, **k)))
    je.process_image(mask)
    te.process_image(mask)
    assert seen["jax"] and set(seen["jax"]) == {8}
    assert len(seen["port"]) == len(seen["jax"])
    assert set(seen["port"]) == {8}
    rows = []
    _, tf = cli.initialize_sessions(models, device="cpu")
    monkeypatch.setattr(tf.encoder, "forward", lambda x, f=tf.encoder.forward:
                        rows.append(x.shape[0]) or f(x))
    tf.process_image(mask)
    assert rows == [3]


def test_process_images_int8_matches_jax(models, monkeypatch):
    """The batched path under int8 over two chunks: each chunk's glyphs
    padded as JAX pads them, the tokens of every chunk as JAX's (or apart
    only where the gap is below ``F32_GAP``), and the masks of
    ``binarize_images`` as JAX's."""
    ov = dict(INT8, io_chunks=2)
    jb, je = j_cli.initialize_sessions(models, se_overrides=ov,
                                       bin_overrides=INT8)
    tb, te = cli.initialize_sessions(models, device="cpu", se_overrides=ov,
                                     bin_overrides=INT8)
    rng = np.random.default_rng(7)
    imgs = []
    for w in (300, 300, 300, 410, 520):
        img = np.full((64, w, 3), 255, np.uint8)
        for _ in range(5):
            y, x = rng.integers(5, 45), rng.integers(0, w - 40)
            img[y:y + rng.integers(3, 12), x:x + rng.integers(5, 40)] = 0
        imgs.append(img)
    jm = [b[:, :, 0] > 127 for b in jb.binarize_images(imgs)]
    tm = [b[:, :, 0] > 127 for b in tb.binarize_images(imgs)]
    agree = np.mean([float((a == b).mean()) for a, b in zip(jm, tm)])
    assert agree >= UNET_MASK_AGREE
    masks = [_glyph_mask(n, seed=n) for n in (2, 3, 1, 4)]
    seen = []
    t_orig = tq.int8_conv2d
    monkeypatch.setattr(tq, "int8_conv2d", lambda x, *a, **k: (
        seen.append(x.shape[0]) or t_orig(x, *a, **k)))
    want_tok, got_tok = (_capture_tokens(je, monkeypatch),
                         _capture_tokens(te, monkeypatch))
    seqs = _capture_seqs(monkeypatch)
    invs = []
    gather = te._gather_batch
    monkeypatch.setattr(te, "_gather_batch", lambda m: (
        lambda out: invs.append(out[1]) or out)(gather(m)))
    je.process_images(masks)
    te.process_images(masks)
    # Chunks of 2 images, fewer than 8 glyphs each, each padded to 8.
    assert set(seen) == {8} and len(seqs) == len(invs) == 2
    # process_tokens runs per image: each chunk's rows in image order, and
    # its K1 sequence (rows by decreasing ink) put back in that order.
    got = [np.concatenate(got_tok[:2]), np.concatenate(got_tok[2:])]
    want = [np.concatenate(want_tok[:2]), np.concatenate(want_tok[2:])]
    assert [g.shape[0] for g in got] == [q.shape[0] for q in seqs]
    _assert_tokens_as_jax(te.decoder, got, want, [
        s[torch.from_numpy(inv)] for s, inv in zip(seqs, invs)])


def test_quant_is_an_execution_policy():
    """``quant`` and ``glyph_bucket`` are left out of an exported model
    dir's configs, as in the JAX package."""
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig as TBin, StrokesConfig as TSe,
    )
    assert "quant" not in TBin(quant="int8").export_dict()
    exported = TSe(quant="int8", glyph_bucket=16).export_dict()
    assert "quant" not in exported and "glyph_bucket" not in exported
    assert TSe().glyph_bucket == StrokesConfig().glyph_bucket == 8

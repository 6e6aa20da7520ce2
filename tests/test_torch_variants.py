"""The model variants an ONNX import produces, the port against the JAX
package on the same numpy-seeded inputs, in float32 on tiny random models:
the UNet with ``norm="batch"`` and ``norm="none"``, the encoder with
``encoder_norm="batch"`` (basic and bottleneck blocks), the projection
head, and whole model directories carrying ``batch_stats`` and
``strokes_projection.msgpack``. Running statistics are drawn away from
flax's zeros and ones (means ~ N(0, 0.3), variances in [0.5, 2]) so that a
batch norm is not the identity."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.weights import store as jstore
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.models.encoder import ResNetEncoder
from stroke_derenderer_tpu_torch.models.layers import linear
from stroke_derenderer_tpu_torch.models.unet import AttentionUNet

ATOL = 1e-4
TINY_BIN = dict(features=(8, 16), bottleneck=16, compute_dtype="float32")
TINY_SE = dict(encoder_arch="tiny", embed_dim=16, attention_dim=16,
               decoder_dim=16, max_length=24, compute_dtype="float32")
# bfloat16: the port and the JAX package round at the same points but sum
# in other orders, so a greedy decode may part from the other by one token
# and go on from there; at least this share of the token positions agree.
BF16_TOKEN_AGREE = 0.9


def randomized(variables, seed):
    """``variables`` (numpy leaves) with every norm's scale, bias, running
    mean and variance drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            norm = any(p.startswith(("BatchNorm", "GroupNorm"))
                       for p in path)
            if k == "mean":
                v = rng.normal(0.0, 0.3, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif norm and k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif norm and k == "bias":
                v = rng.uniform(-0.3, 0.3, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out
    return walk(variables)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


@pytest.mark.parametrize("norm", ["batch", "none", "group"])
def test_unet_variants_match_jax(norm):
    cfg = BinarizerConfig(norm=norm, **TINY_BIN)
    model, variables = jstore.init_binarizer_variables(cfg, 0)
    variables = randomized(_np_tree(variables), 1)
    assert ("batch_stats" in variables) == (norm == "batch")
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 64, 3)).astype(
        np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    tu = AttentionUNet(cfg.features, cfg.bottleneck, dtype=torch.float32,
                       norm=norm)
    tu.load_state_dict(tw.from_flax_unet(variables, len(cfg.features)))
    with torch.no_grad():
        got = tu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # The state maps back to the same variables, leaf for leaf.
    back = tw.unet_variables(tu.state_dict(), len(cfg.features))
    assert_trees_equal(back, variables)


@pytest.mark.parametrize("arch,size", [("tiny", 56), ("resnet50", 64)])
def test_batch_norm_encoder_matches_jax(arch, size):
    """Basic blocks (tiny) and bottleneck blocks (resnet50, the JAX
    default, on a 64 px crop: the network is fully convolutional)."""
    import jax

    from stroke_derenderer_tpu.models.encoder import (
        ResNetEncoder as JEncoder,
    )
    from stroke_derenderer_tpu_torch.models.encoder import ARCHS
    x = np.random.default_rng(4).normal(0, 1, (2, size, size, 3)).astype(
        np.float32)
    model = JEncoder(arch=arch, dtype=jnp.float32, norm="batch")
    enc_vars = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    enc_vars = randomized(_np_tree(enc_vars), 3)
    want = np.asarray(jax.jit(model.apply)(enc_vars, jnp.asarray(x)))
    te = ResNetEncoder(arch, dtype=torch.float32, norm="batch")
    kind = ARCHS[arch][0]
    te.load_state_dict(tw.from_flax_encoder(enc_vars, kind))
    with torch.no_grad():
        got = te(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    assert_trees_equal(tw.encoder_variables(te.state_dict(), kind),
                       enc_vars)


def test_projection_matches_flax_dense():
    import flax.linen as nn
    rng = np.random.default_rng(5)
    kernel = rng.normal(0, 0.2, (64, 12)).astype(np.float32)
    bias = rng.normal(0, 0.2, 12).astype(np.float32)
    x = rng.normal(0, 1, (3, 16, 64)).astype(np.float32)
    params = {"params": {"kernel": kernel, "bias": bias}}
    proj = torch.nn.Linear(64, 12)
    proj.load_state_dict(tw.from_flax_projection(params))
    for name, jdt, tdt, atol in (("float32", jnp.float32, torch.float32,
                                  1e-5),
                                 ("bfloat16", jnp.bfloat16, torch.bfloat16,
                                  0.0)):
        want = np.asarray(nn.Dense(12, dtype=jdt).apply(
            params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
        with torch.no_grad():
            got = linear(torch.from_numpy(x).to(tdt), proj).float().numpy()
        # bfloat16: one rounding of a float32-accumulated product, then the
        # bias in bfloat16; sums of 64 terms in another order can differ by
        # one bfloat16 ulp before the bias.
        tol = atol or 2 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, err_msg=name)
    assert_trees_equal(tw.to_flax_projection(proj.state_dict()),
                       params["params"])


def assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), f"{path}: {set(got)} != {set(want)}"
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{path}/{k}"
            assert np.array_equal(a, b), f"{path}/{k}"


def variant_dir(path, seed=0, **se):
    """A JAX-made tiny model dir (``materialize_model_dir``) with batch
    norms in both networks and a projection head, its norms' statistics
    drawn from ``seed`` and written back."""
    bin_cfg = BinarizerConfig(norm="batch", **TINY_BIN)
    se_cfg = StrokesConfig(**(TINY_SE | dict(encoder_norm="batch",
                                             projection_dim=12) | se))
    jstore.materialize_model_dir(path, bin_cfg, se_cfg, seed)
    for i, name in enumerate(("binarizer", "strokes_encoder")):
        f = path / f"{name}.msgpack"
        tw.write_msgpack(randomized(tw.read_msgpack(f), seed + i), f)
    return path


def _masks(seed=6):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, 200)
    out = []
    for w, n in ((300, 4), (200, 2)):
        m = np.zeros((128, w), bool)
        for _ in range(n):
            cx, cy = rng.integers(20, w - 20), rng.integers(20, 108)
            r = rng.integers(5, 18)
            m[np.clip((cy + r * np.sin(t)).astype(int), 0, 127),
              np.clip((cx + r * np.cos(t * rng.uniform(0.5, 2))).astype(int),
                      0, w - 1)] = True
        out.append(m)
    return out


def _same_strokes(a, b):
    assert len(a) == len(b)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_variant_dir_loads_and_matches_jax(tmp_path):
    """A native dir with batch norms and ``strokes_projection.msgpack``:
    the port's masks and its greedy (K1's plain version) and beam strokes
    are the JAX package's, bit for bit, per image and batched."""
    d = variant_dir(tmp_path)
    tb, te = cli.initialize_sessions(d, device="cpu")
    assert te.projection is not None and te.config.projection_dim == 12
    assert te.decoder.enc_att_w.shape[0] == 12
    jb, je = j_cli.initialize_sessions(d)
    img = np.full((40, 150, 3), 255, np.uint8)
    img[12:28, 20:60] = 0
    img[15:20, 90:140] = 0
    np.testing.assert_array_equal(tb.binarize_image(img),
                                  jb.binarize_image(img))
    masks = _masks()
    want = [je.process_image(m) for m in masks]
    assert sum(len(s) for s in want) > 0
    for m, w in zip(masks, want):
        _same_strokes(te.process_image(m), w)
    for g, w in zip(te.process_images(masks), want):
        _same_strokes(g, w)
    beam = {"decode": "beam", "beam_size": 3}
    _, jbe = j_cli.initialize_sessions(d, se_overrides=beam)
    _, tbe = cli.initialize_sessions(d, device="cpu", se_overrides=beam)
    _same_strokes(tbe.process_image(masks[0]), jbe.process_image(masks[0]))


def test_variant_dir_bfloat16_token_agreement(tmp_path):
    """bfloat16 compute on the same dir: the port's tokens against the JAX
    package's, at least ``BF16_TOKEN_AGREE`` of the positions."""
    from stroke_derenderer_tpu_torch.pipeline.strokes import (
        compute_partitions,
    )
    d = variant_dir(tmp_path, compute_dtype="bfloat16")
    _, je = j_cli.initialize_sessions(d)
    _, te = cli.initialize_sessions(d, device="cpu")
    assert te.compute_dtype == torch.bfloat16
    agree = total = 0
    for m in _masks():
        crops = np.stack([p["image"] for p in compute_partitions(
            m, te.config)]).astype(np.uint8)
        want = je.estimate_strokes(crops)
        got = te._encode_and_decode(torch.from_numpy(crops).float(),
                                    None).numpy()
        decoded = (got != 0) | (want != 0)
        agree += int((got == want)[decoded].sum())
        total += int(decoded.sum())
    assert total > 0
    assert agree / total >= BF16_TOKEN_AGREE, agree / total


def test_quant_still_refused(tmp_path):
    """int8 was refused until it was ported; now the variants run it too
    (batch-norm UNet and encoder, projection head): the int8 convs are
    called, the float32 masks are the JAX package's, and the encoder sees
    its glyph batch padded to glyph_bucket, as JAX pads it."""
    from stroke_derenderer_tpu_torch.ops import quant
    d = variant_dir(tmp_path)
    ov = {"quant": "int8"}
    jb, _ = j_cli.initialize_sessions(d, se_overrides=ov, bin_overrides=ov)
    tb, te = cli.initialize_sessions(d, device="cpu", se_overrides=ov,
                                     bin_overrides=ov)
    assert te.encoder.quant == "int8"
    img = np.full((64, 300, 3), 255, np.uint8)
    img[20:30, 40:200] = 0
    img[40:44, 60:280] = 30
    want = jb.binarize_image(img)
    calls = quant.call_count
    got = tb.binarize_image(img)
    assert quant.call_count > calls
    assert float((got == want).mean()) >= 0.99
    seen = []
    orig = te.encoder.forward
    te.encoder.forward = lambda x: seen.append(x.shape[0]) or orig(x)
    m = _masks()[0]
    assert te.process_image(m) is not None
    assert seen and all(n % te.config.glyph_bucket == 0 for n in seen)


def test_projection_file_missing_is_an_error(tmp_path):
    d = variant_dir(tmp_path)
    (d / "strokes_projection.msgpack").unlink()
    with pytest.raises(ValueError, match="projection"):
        cli.initialize_sessions(d, device="cpu")


def test_port_materializes_the_variants(tmp_path):
    """The port's own random dir with batch norms and a projection: the
    JAX package loads it, and both give the same strokes."""
    bin_cfg = BinarizerConfig(norm="batch", **TINY_BIN)
    se_cfg = StrokesConfig(**(TINY_SE | dict(encoder_norm="batch",
                                             projection_dim=12)))
    tw.materialize_model_dir(tmp_path, bin_cfg, se_cfg, seed=2)
    assert (tmp_path / "strokes_projection.msgpack").exists()
    stats = tw.read_msgpack(tmp_path / "binarizer.msgpack")["batch_stats"]
    assert set(stats["ConvBlock_0"]) == {"BatchNorm_0", "BatchNorm_1"}
    _, je = j_cli.initialize_sessions(tmp_path)
    _, te = cli.initialize_sessions(tmp_path, device="cpu")
    m = _masks()[0]
    _same_strokes(te.process_image(m), je.process_image(m))


@pytest.mark.parametrize("which", ["binarizer", "encoder", "projection"])
def test_trainer_refuses_the_untrained_variants(tmp_path, which):
    """The trainer trains no running statistics and no projection head (nor
    does the JAX trainer): it refuses such a model before any step."""
    from stroke_derenderer_tpu_torch.train import loop
    if which == "binarizer":
        with pytest.raises(NotImplementedError, match="batch-norm"):
            loop.train_binarizer(BinarizerConfig(norm="batch", **TINY_BIN),
                                 1, 1, tmp_path, device="cpu")
        return
    se = ({"encoder_norm": "batch"} if which == "encoder"
          else {"projection_dim": 12})
    with pytest.raises(NotImplementedError, match="projection head"):
        loop.train_captioner(StrokesConfig(**(TINY_SE | se)), 1, 1,
                             tmp_path, device="cpu")

"""The port's trainer against the JAX package's, in float32 on tiny models:
the losses, the teacher-forced decoder, one step's gradients, the
learning-rate schedule, AdamW, the EMA, on-device normalization, scheduled
sampling, the flax layout maps, the mesh flags, and the kernels'
packed-weight caches after an update. Random init, checkpoints both ways
and the loop end to end are in ``tests/test_torch_train_loop.py``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.data import synthetic as jsyn
from stroke_derenderer_tpu.models import encode_postprocess as j_post
from stroke_derenderer_tpu.train import loop as jloop
from stroke_derenderer_tpu.train import losses as jl
from stroke_derenderer_tpu.train import steps as jsteps
from stroke_derenderer_tpu.weights import store as jstore
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import (
    BinarizerConfig as TBinarizerConfig, StrokesConfig as TStrokesConfig,
)
from stroke_derenderer_tpu_torch.kernels import decode_attention as da
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
from stroke_derenderer_tpu_torch.train import checkpoint as tckpt
from stroke_derenderer_tpu_torch.train import loop as tloop
from stroke_derenderer_tpu_torch.train import losses as tl
from stroke_derenderer_tpu_torch.train import steps as tsteps

REPO = Path(__file__).resolve().parent.parent
NARROW = REPO / "models_bin_narrow"
BIN_KW = dict(features=(8,), bottleneck=16, compute_dtype="float32")
SE_KW = dict(encoder_arch="tiny", embed_dim=16, attention_dim=16,
             decoder_dim=16, compute_dtype="float32")
SEQ = 12
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _tree_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert np.array_equal(la[k], lb[k]), k


def _close_after_adamw(got, want, lr, steps):
    """AdamW divides by the root of the second moment, so a gradient that
    rounds to another tiny value can move an element by up to lr a step:
    every element within 2 * lr * steps, and 99.9% within 1e-5."""
    n_ok = n = 0
    for (kg, g), (kw, w) in zip(_leaves(got), _leaves(want)):
        assert kg == kw
        d = np.abs(g.astype(np.float64) - w)
        assert d.max() <= 2 * lr * steps, (kg, d.max())
        n_ok += int((d <= 1e-5).sum())
        n += d.size
    assert n_ok >= 0.999 * n, (n_ok, n)


@pytest.fixture(scope="module")
def tiles():
    return list(jsyn.tile_batches(np.random.default_rng(0), 2, 128, 384,
                                  n_batches=3, style="letters", ruled=0.5,
                                  narrow=0.5))


@pytest.fixture(scope="module")
def glyphs():
    return list(jsyn.partitioned_glyph_batches(np.random.default_rng(0), 2,
                                               SEQ, n_batches=3,
                                               style="hand"))


@pytest.fixture(scope="module")
def jax_bin():
    """The JAX binarizer (tiny, float32), its init, and a jitted loss."""
    cfg = BinarizerConfig(**BIN_KW)
    model, variables = jstore.init_binarizer_variables(cfg, 0)
    loss = jax.jit(lambda p, x, y: jl.binarize_loss(
        model.apply({"params": p}, x), y))
    return cfg, model, variables["params"], loss


@pytest.fixture(scope="module")
def jax_cap():
    """The JAX captioner (tiny, float32), its init, and jitted losses."""
    cfg = StrokesConfig(**SE_KW)
    enc, dec, ev, dv, _ = jstore.init_strokes_variables(cfg, 0)
    params = {"encoder": ev["params"], "decoder": dv["params"]}

    def loss(p, images, tin, tout, sigma):
        seq = j_post(enc.apply({"params": p["encoder"]}, images), 14)
        logits = dec.apply({"params": p["decoder"]}, seq, tin)
        return jl.caption_loss(logits, tout, coord_sigma=sigma)

    return cfg, enc, dec, params, jax.jit(loss, static_argnums=4)


def _port_bin(params):
    cfg = TBinarizerConfig(**BIN_KW)
    model = tw.init_binarizer(cfg)
    model.load_state_dict(tw.from_flax_unet(params, 1))
    return cfg, model


def _port_cap(params):
    cfg = TStrokesConfig(**SE_KW)
    enc, dec = tw.init_strokes(cfg)
    cap = tsteps.Captioner(enc, dec)
    layout = tloop._captioner_layout(cfg)
    cap.load_state_dict(layout.from_tree(params))
    dec.requires_grad_(True)
    return cfg, cap, layout


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.5])
def test_caption_loss_matches_jax(sigma):
    rng = np.random.default_rng(int(sigma * 10))
    logits = rng.normal(0, 3, (3, 17, 451)).astype(np.float32)
    tg = rng.integers(0, 451, (3, 17)).astype(np.int32)
    tg[:, -4:] = 0
    tg[0, :6] = [1, 2, 3, 4, 225, 226]     # specials and both axis edges
    tg[1, :4] = [227, 228, 449, 450]
    want = float(jl.caption_loss(jnp.asarray(logits), jnp.asarray(tg),
                                 coord_sigma=sigma))
    got = tl.caption_loss(_t(logits), _t(tg), coord_sigma=sigma)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    # All targets PAD: no position counts, the loss is 0.
    assert float(tl.caption_loss(_t(logits), torch.zeros(3, 17,
                                                         dtype=torch.int32),
                                 coord_sigma=sigma)) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_binarize_and_dice_loss_match_jax(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (3, 16, 24, 1)).astype(np.float32)
    p[0, 0, :3, 0] = [0.0, 1.0, 1e-9]       # the clip at 1e-6
    y = (rng.uniform(size=p.shape) > 0.7).astype(np.float32)
    y[2] = 0.0
    for jf, tf in ((jl.binarize_loss, tl.binarize_loss),
                   (jl.dice_loss, tl.dice_loss)):
        want = float(jf(jnp.asarray(p), jnp.asarray(y)))
        got = float(tf(_t(p), _t(y)))
        assert abs(got - want) <= 1e-6 * abs(want)


# ------------------------------------------------------ decoder forward

def test_teacher_forced_logits_match_jax_and_greedy_tokens(jax_cap):
    _, _, jd, params, _ = jax_cap
    rng = np.random.default_rng(3)
    enc = rng.normal(0, 1, (3, 196, 64)).astype(np.float32)
    toks = rng.integers(0, 451, (3, 20)).astype(np.int32)
    want = np.asarray(jd.apply({"params": params["decoder"]}, enc, toks))
    dec = AttentiveDecoder(451, 16, 16, 16, 64, dtype=torch.float32)
    dec.load_state_dict(tw.from_flax_decoder(
        jax.tree.map(np.asarray, params["decoder"])))
    with torch.no_grad():
        got = dec(_t(enc), _t(toks).long())
    assert got.dtype == torch.float32 and got.shape == (3, 20, 451)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    # Fed BOS and the greedy tokens of K1's plain version, the shipped
    # decoder's teacher-forced pass takes the same argmax wherever the
    # greedy step's top-2 gap is clear.
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    dec = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.float32)
    dec.load_state_dict(tw.from_flax_decoder(tree))
    enc = np.maximum(rng.normal(1.0, 1.5, (2, 196, 512)), 0).astype(
        np.float32)
    with torch.no_grad():
        e = _t(enc)
        preds, gaps = fd.fused_greedy_decode_plain(
            e, dec.project_encoding(e), *dec.init_state(e),
            dec.weights(torch.float32), 24, True)
        tin = torch.cat([torch.ones(2, 1, dtype=torch.long),
                         preds[:, :-1].long()], 1)
        tf = dec(e, tin).argmax(-1)
    live = torch.isfinite(gaps) & (gaps > 1e-4)
    assert live.sum() > 10
    assert torch.equal(tf[live], preds.long()[live])


def test_gradients_reach_every_parameter_and_match_jax(jax_bin, jax_cap,
                                                        tiles, glyphs):
    """One step's gradients, leaf by leaf, within 1e-4 of the leaf's
    largest value, for the binarizer and for the captioner (with and
    without coordinate smoothing)."""
    bcfg, _, bparams, bloss = jax_bin
    x, y = tiles[0]
    want = jax.grad(bloss)(bparams, x, y)
    _, model = _port_bin(jax.tree.map(np.asarray, bparams))
    tl.binarize_loss(model(_t(x)), _t(y)).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    got = tw.to_flax_unet({k: p.grad for k, p in model.named_parameters()},
                          1)
    for (k, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k

    _, _, _, cparams, closs = jax_cap
    images, tin, tout = glyphs[0]
    for sigma in (0.0, 1.0):
        want = jax.grad(closs)(cparams, images, tin, tout, sigma)
        _, cap, layout = _port_cap(jax.tree.map(np.asarray, cparams))
        seq = tsteps.encode_postprocess(cap.encoder(_t(images)), 14)
        tl.caption_loss(cap.decoder(seq, _t(tin).long()), _t(tout),
                        coord_sigma=sigma).backward()
        grads = {k: p.grad for k, p in cap.named_parameters()}
        assert all(g is not None for g in grads.values())
        got = layout.to_tree(grads)
        scale = max(np.abs(w).max() for _, w in _leaves(want))
        for (k, g), (_, w) in zip(_leaves(got), _leaves(want)):
            if k == "/decoder/full_att/bias":
                # The softmax over positions ignores a shift of the scores:
                # this gradient is zero up to rounding in both.
                assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * scale
                continue
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (sigma, k)


# ------------------------------------------------- schedule and AdamW

@pytest.mark.parametrize("steps", [2, 3, 10, 40, 60, 300, 2000])
def test_lr_schedule_matches_optax(steps):
    """Exact through the warmup; after it each value within 3e-7 of optax's
    (XLA's float32 cosine is an approximation that lies an ulp or two off
    the correctly rounded one at some arguments) and equal at almost all
    counts."""
    warm = tsteps.warmup_steps(steps)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warm, steps)
    same = 0
    for c in range(steps + 2):
        want = float(sched(jnp.int32(c)))
        got = tsteps.lr_at(c, 3e-4, steps)
        if c <= warm or c >= steps:
            assert got == want, c
        assert abs(got - want) <= 3e-7 * abs(want), c
        same += got == want
    assert same >= 0.97 * (steps + 2)
    assert tsteps.lr_at(0, 3e-4, steps) == 0.0
    with pytest.raises(ValueError):
        tsteps.lr_at(0, 3e-4, 1)


def test_three_adamw_steps_match_optax(jax_bin, tiles):
    cfg, model_j, params, _ = jax_bin
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, LR, tsteps.warmup_steps(3), 3))
    step_j = jax.jit(jsteps.make_binarizer_train_step(model_j, tx))
    opt = tx.init(params)
    p = params
    losses_j = []
    for x, y in tiles:
        p, opt, loss = step_j(p, opt, x, y)
        losses_j.append(float(loss))
    _, model = _port_bin(jax.tree.map(np.asarray, params))
    optimizer = tsteps.make_optimizer(model)
    step = tsteps.make_binarizer_train_step(
        model, optimizer, lambda c: tsteps.lr_at(c, LR, 3))
    losses = [float(step(_t(x), _t(y))) for x, y in tiles]
    assert abs(losses[0] - losses_j[0]) <= 1e-5 * losses_j[0]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    assert tsteps.update_count(optimizer) == 3
    _close_after_adamw(tw.to_flax_unet(model.state_dict(), 1),
                       jax.tree.map(np.asarray, p), LR, 3)
    # The optimizer state in optax's layout.
    tree = tckpt.opt_state_tree(optimizer, model,
                                lambda sd: tw.to_flax_unet(sd, 1))
    assert int(tree["0"]["count"]) == int(tree["2"]["count"]) == 3
    assert tree["1"] == {}
    for part in ("mu", "nu"):
        _close_after_adamw(tree["0"][part],
                           jax.tree.map(np.asarray, opt[0]._asdict()[part]),
                           1e-6, 1)


# ------------------------------------- EMA, normalization, sampling

def test_ema_matches_jax_exactly(jax_bin):
    _, _, params, _ = jax_bin
    params = jax.tree.map(np.asarray, params)
    _, model = _port_bin(params)
    ema_t = tloop._Ema(0.999, model)
    ema_j = jloop._Ema(0.999, params, lambda t: t)
    rng = np.random.default_rng(0)
    for step in (1, 2, 3, 57, 4000):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(
                    np.float32)))
        ema_t.update(model, step)
        ema_j.update(jax.tree.map(np.asarray, tw.to_flax_unet(
            model.state_dict(), 1)), step)
        _tree_equal(tw.to_flax_unet(ema_t.params, 1),
                    jax.tree.map(np.asarray, ema_j.params))


def test_device_normalize_u8_matches_jax_exactly():
    rng = np.random.default_rng(0)
    crops = rng.integers(0, 256, (4, 224, 224)).astype(np.uint8)
    crops[1] = rng.integers(40, 90, (224, 224))       # a narrow range
    crops[2] = 7                                       # constant
    crops[3] = np.where(rng.uniform(size=(224, 224)) > 0.5, 255, 0)
    cfg = StrokesConfig()
    want = np.asarray(jsteps.device_normalize_u8(jnp.asarray(crops),
                                                 cfg.mean, cfg.std))
    got = tsteps.device_normalize_u8(_t(crops), cfg.mean, cfg.std).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_scheduled_sampling_with_injected_mask_matches_jax(jax_cap,
                                                           glyphs):
    """The JAX step draws its take-mask from PRNGKey(0) folded with the
    step; given that mask, the port's step makes the same mixed inputs and
    the same loss."""
    _, enc, dec, params, _ = jax_cap
    images, tin, tout = glyphs[1]
    step_idx, total, frac, prob = 7, 20, 0.5, 0.6
    captured = {}

    def spy(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), state

    tx = optax.GradientTransformation(lambda p: optax.EmptyState(), spy)
    step_j = jax.jit(jsteps.make_captioner_train_step(
        enc, dec, tx, coord_sigma=1.0, sample_prob=prob, total_steps=total,
        ss_ramp_frac=frac))
    _, _, loss_j = step_j(params, tx.init(params), images, tin, tout,
                          jnp.int32(step_idx))
    key = jax.random.fold_in(jax.random.PRNGKey(0), step_idx)
    p = prob * min(step_idx / max(total * frac, 1.0), 1.0)
    take = np.asarray(jax.random.bernoulli(key, p, tin.shape))
    assert 0 < take.sum() < take.size

    _, cap, _ = _port_cap(jax.tree.map(np.asarray, params))
    forward = cap.decoder.forward

    def record(seq, toks):
        captured.setdefault("inputs", []).append(toks.clone())
        return forward(seq, toks)

    cap.decoder.forward = record
    optimizer = tsteps.make_optimizer(cap)
    step = tsteps.make_captioner_train_step(
        cap, optimizer, lambda c: 0.0, coord_sigma=1.0, sample_prob=prob,
        total_steps=total, ss_ramp_frac=frac)
    loss = float(step(_t(images), _t(tin).long(), _t(tout).long(),
                      step_idx=step_idx, take=_t(take)))
    assert abs(loss - float(loss_j)) <= 1e-6 * float(loss_j)
    first, mixed = captured["inputs"]
    assert torch.equal(first, _t(tin).long())
    with torch.no_grad():
        preds = forward(tsteps.encode_postprocess(
            cap.encoder(_t(images)), 14), _t(tin).long()).argmax(-1)
    prev = torch.cat([_t(tin)[:, :1].long(), preds[:, :-1]], 1)
    keep = _t(take) & (_t(tin) != 0)
    assert torch.equal(mixed, torch.where(keep, prev, _t(tin).long()))
    assert torch.equal(mixed[_t(tin) == 0], _t(tin).long()[_t(tin) == 0])


def test_scheduled_sampling_mask_rate_and_ramp():
    shape = (64, 96)
    n = shape[0] * shape[1]
    for step, want in ((0, 0.0), (5, 0.125), (10, 0.25), (30, 0.25)):
        m = tsteps.scheduled_sampling_mask(shape, step, 0.25, 40, 0.25, 3,
                                           "cpu")
        sd = (n * want * (1 - want)) ** 0.5
        assert abs(int(m.sum()) - n * want) <= 5 * sd + 1e-9, step
    a = tsteps.scheduled_sampling_mask(shape, 12, 0.25, 40, 0.25, 3, "cpu")
    b = tsteps.scheduled_sampling_mask(shape, 12, 0.25, 40, 0.25, 3, "cpu")
    c = tsteps.scheduled_sampling_mask(shape, 13, 0.25, 40, 0.25, 3, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


# --------------------------------------------------- layouts and init

@pytest.mark.parametrize("name", ["binarizer", "strokes_encoder",
                                  "strokes_decoder"])
def test_to_flax_inverts_from_flax_bit_for_bit(name):
    path = REPO / "models_demo" / f"{name}.msgpack"
    tree = tw.read_msgpack(path)
    back = {"binarizer": lambda t: tw.to_flax_unet(tw.from_flax_unet(t, 3),
                                                   3),
            "strokes_encoder": lambda t: tw.to_flax_encoder(
                tw.from_flax_encoder(t, "basic"), "basic"),
            "strokes_decoder": lambda t: tw.to_flax_decoder(
                tw.from_flax_decoder(t))}[name](tree)
    _tree_equal({"params": back}, tree)
    assert tw.msgpack_bytes({"params": back}) == path.read_bytes()


def test_msgpack_writer_matches_flax_bytes():
    import flax.serialization
    for p in [NARROW / "ckpt_binarizer" / "step_00002000" / f
              for f in ("params.msgpack", "opt_state.msgpack",
                        "extra_ema.msgpack")]:
        assert tw.msgpack_bytes(tw.read_msgpack(p)) == p.read_bytes()
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.zeros((), np.float32), "d": {}},
            "e" * 40: np.ones((300,), np.float32)}
    assert tw.msgpack_bytes(tree) == flax.serialization.msgpack_serialize(
        tree)


def test_mesh_flags_raise_and_the_card_is_the_default(monkeypatch, tmp_path):
    """The mesh flags train: ``--mesh 2 --tp 2`` on two CPU ranks (the
    kernels column-parallel; rank 0's checkpoints and export hold whole
    tensors, and a single process resumes them), ``--distributed``
    without a fleet alone; and the card is the default."""
    base = ["--device", "cpu", "--model", "both", "--batch", "2",
            "--bin-features", "8", "--encoder-arch", "tiny", "--se-dims",
            "16,16,16", "--seq-len", "12"]
    res = tloop.train(base + ["--steps", "2", "--mesh", "2", "--tp", "2",
                              "--out", str(tmp_path / "m")], num_workers=1)
    assert all(len(r.losses) == 2 for r in res.values())
    whole = tw.init_binarizer(TBinarizerConfig(features=(8,),
                                               bottleneck=16), 0)
    assert {k: tuple(v.shape) for k, v in res["binarizer"].exported.items()
            } == {k: tuple(v.shape) for k, v in whole.state_dict().items()}
    res = tloop.train(base + ["--steps", "3", "--out", str(tmp_path / "m")],
                      num_workers=1)
    assert {k: r.start_step for k, r in res.items()} == {
        "binarizer": 2, "captioner": 2}
    for var in ("SD_COORDINATOR", "SD_NUM_PROCESSES", "SD_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    res = tloop.train(base + ["--steps", "2", "--distributed", "--out",
                              str(tmp_path / "d")], num_workers=1)
    assert all(len(r.losses) == 2 for r in res.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.main(["--out", str(tmp_path), "--steps", "2"])


# ------------------------------------------- kernel caches after a step

@pytest.mark.parametrize("fused", [False, True])
def test_packed_weight_caches_follow_an_update(fused, glyphs):
    cfg = TStrokesConfig(**SE_KW)
    enc, dec = tw.init_strokes(cfg, 1)
    cap = tsteps.Captioner(enc, dec)
    dec.requires_grad_(True)
    optimizer = torch.optim.AdamW(cap.parameters(), lr=1e-2, fused=fused)
    with torch.no_grad():
        before = {k: v.clone() for k, v in
                  fd.step_weights(dec, torch.float32).items()}
        da.attention_weights(dec)
    step = tsteps.make_captioner_train_step(cap, optimizer, lambda c: 1e-2)
    images, tin, tout = glyphs[0]
    step(_t(images), _t(tin).long(), _t(tout).long())
    with torch.no_grad():
        fresh = fd.pack_step_weights(dec.weights(torch.float32))
        cached = fd.step_weights(dec, torch.float32)
        att = da.pack_attention_weights(*(getattr(dec, k) for k in (
            "watt", "batt", "v", "wf", "bf")))
        att_cached = da.attention_weights(dec)
    assert any(not torch.equal(before[k], fresh[k]) for k in fresh)
    for k in fresh:
        assert torch.equal(cached[k], fresh[k]), k
    for k in att:
        assert torch.equal(att_cached[k], att[k]), k


def test_partial_warm_start_matches_jax(tmp_path):
    """``--init-partial``: the stage-aligned block map of a ResNet
    deepening, and the shape-matched merge from a model dir of other
    widths, as the JAX trainer makes them; then a run from it."""
    for src, dst in (("resnet18", "resnet34"), ("tiny", "resnet18"),
                     ("resnet50", "resnet101"), ("resnet34", "resnet18")):
        assert tloop._deepen_remap(src, dst) == jloop._deepen_remap(src, dst)
    tw.materialize_model_dir(tmp_path / "src", TBinarizerConfig(**BIN_KW),
                             TStrokesConfig(**SE_KW))
    cfg = TStrokesConfig(**dict(SE_KW, embed_dim=8))
    layout = tloop._captioner_layout(cfg)
    fresh = layout.to_tree(tsteps.Captioner(*tw.init_strokes(cfg, 4))
                           .state_dict())
    got = tloop._partial_warm_start(fresh, tmp_path / "src", "tiny")
    want = jloop._partial_warm_start(fresh, tmp_path / "src", "tiny")
    _tree_equal(got, jax.tree.map(np.asarray, want))
    src = tw.read_msgpack(tmp_path / "src" / "strokes_decoder.msgpack")
    assert np.array_equal(got["decoder"]["fc"]["kernel"],
                          src["params"]["fc"]["kernel"])
    assert np.array_equal(got["decoder"]["embedding"]["embedding"],
                          fresh["decoder"]["embedding"]["embedding"])
    assert tloop.main(["--device", "cpu", "--model", "captioner", "--steps",
                       "2", "--batch", "1", "--seq-len", "12",
                       "--encoder-arch", "tiny", "--se-dims", "8,16,16",
                       "--init-partial", str(tmp_path / "src"), "--out",
                       str(tmp_path / "out")], num_workers=1) == 0
    assert (tmp_path / "out" / "strokes_decoder.msgpack").exists()

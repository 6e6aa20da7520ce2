"""The port's trainer end to end against the JAX package's: random init
and ``--init-models``, checkpoints both ways (the committed JAX
checkpoint resumed, the port's restored by the JAX package) and the loop
against the JAX loop with one loader worker. These tests came from
``tests/test_torch_train.py`` unchanged, to balance the test run's files;
they share its constants, helpers and batches."""

import json
import shutil

import jax
import numpy as np
import optax

from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.data import loader as jloader
from stroke_derenderer_tpu.train import checkpoint as jckpt
from stroke_derenderer_tpu.train import loop as jloop
from stroke_derenderer_tpu.weights import store as jstore
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import (
    BinarizerConfig as TBinarizerConfig, StrokesConfig as TStrokesConfig,
)
from stroke_derenderer_tpu_torch.train import checkpoint as tckpt
from stroke_derenderer_tpu_torch.train import loop as tloop
from stroke_derenderer_tpu_torch.train import steps as tsteps
from test_torch_train import (  # noqa: F401
    BIN_KW, LR, NARROW, SE_KW, SEQ, _close_after_adamw, _tree_equal, tiles,
)


def test_init_draws_flax_families_and_the_jax_package_loads_it(tmp_path):
    bcfg, scfg = TBinarizerConfig(**BIN_KW), TStrokesConfig(**SE_KW)
    tw.materialize_model_dir(tmp_path, bcfg, scfg, seed=3)
    jb = BinarizerConfig.from_json(tmp_path / "configs_binarizer.json")
    js = StrokesConfig.from_json(tmp_path / "configs_strokes.json")
    assert jb.features == (8,) and js.encoder_arch == "tiny"
    _, bt = jstore.binarizer_template(jb)
    jv = jstore.load_variables(bt, tmp_path / "binarizer.msgpack")
    tree = tw.read_msgpack(tmp_path / "binarizer.msgpack")
    _tree_equal(tree, jax.tree.map(np.asarray, jv))
    p = tree["params"]
    assert np.all(p["ConvBlock_0"]["GroupNorm_0"]["scale"] == 1)
    assert np.all(p["head"]["bias"] == 0)
    k = p["ConvBlock_1"]["Conv_0"]["kernel"]            # 3x3x8 fan-in
    std = np.sqrt(1 / 72)
    assert np.abs(k).max() <= 2 * std / .87962566103423978 + 1e-6
    assert abs(k.std() - std) < 0.15 * std
    dec = tw.read_msgpack(tmp_path / "strokes_decoder.msgpack")["params"]
    hi = dec["lstm"]["hi"]["kernel"]
    np.testing.assert_allclose(hi.T @ hi, np.eye(16), atol=1e-5)
    emb = dec["embedding"]["embedding"]
    assert abs(emb.std() - 0.25) < 0.02                   # 1 / sqrt(16)
    # Seeded: the same seed draws the same numbers.
    tw.materialize_model_dir(tmp_path / "again", bcfg, scfg, seed=3)
    for f in ("binarizer", "strokes_encoder", "strokes_decoder"):
        assert (tmp_path / f"{f}.msgpack").read_bytes() == (
            tmp_path / "again" / f"{f}.msgpack").read_bytes()


def test_cli_init_models_and_random_fallback(tmp_path, capsys):
    assert cli.entrypoint(["--init-models", str(tmp_path / "m")]) == 0
    assert (tmp_path / "m" / "strokes_decoder.msgpack").exists()
    cfg = json.loads((tmp_path / "m" / "configs_strokes.json").read_text())
    assert cfg == StrokesConfig().export_dict()
    tw.materialize_model_dir(tmp_path / "tiny", TBinarizerConfig(**BIN_KW),
                             TStrokesConfig(**SE_KW))
    (tmp_path / "tiny" / "strokes_decoder.msgpack").unlink()
    b, e = cli.initialize_sessions(tmp_path / "tiny", device="cpu")
    out = capsys.readouterr().out
    assert "stroke model weights not found" in out
    assert e.decoder.emb.shape == (451, 16)
    b2, _ = cli.initialize_sessions(None, device="cpu")
    assert b2.config.features == BinarizerConfig().features


# ---------------------------------------------------------- checkpoints

def test_port_resumes_the_committed_jax_checkpoint(tmp_path):
    src = NARROW / "ckpt_binarizer" / "step_00002000"
    cfg = TBinarizerConfig.from_json(NARROW / "configs_binarizer.json",
                                     compute_dtype="float32")
    model = tw.init_binarizer(cfg)
    optimizer = tsteps.make_optimizer(model)
    layout = tloop._unet_layout(cfg)
    step, ema = tloop._resume(model, optimizer, layout, src.parent, 0.999,
                              "binarizer")
    assert step == 2000
    _tree_equal({"p": layout.to_tree(model.state_dict())},
                {"p": tw.read_msgpack(src / "params.msgpack")})
    _tree_equal(tckpt.opt_state_tree(optimizer, model, layout.to_tree),
                tw.read_msgpack(src / "opt_state.msgpack"))
    _tree_equal({"p": layout.to_tree(ema)},
                {"p": tw.read_msgpack(src / "extra_ema.msgpack")})
    # The loop takes it from there: one more step, at step 2000.
    out = tmp_path / "run"
    (out / "ckpt_binarizer").mkdir(parents=True)
    shutil.copytree(src, out / "ckpt_binarizer" / src.name)
    res = tloop.train_binarizer(cfg, 2001, 1, out, seed=0, ema_decay=0.999,
                                device="cpu", num_workers=1)
    assert res.start_step == 2000 and len(res.losses) == 1
    assert np.isfinite(res.losses[0])
    assert tckpt.latest_checkpoint(out / "ckpt_binarizer").name == \
        "step_00002001"


def test_jax_restores_the_ports_checkpoint(tmp_path, tiles):
    cfg = TBinarizerConfig(**BIN_KW)
    res = tloop.train_binarizer(cfg, 2, 2, tmp_path, ema_decay=0.99,
                                device="cpu", num_workers=1, ckpt_every=1,
                                ckpt_keep=1)
    last = tckpt.latest_checkpoint(tmp_path / "ckpt_binarizer")
    assert [p.name for p in (tmp_path / "ckpt_binarizer").iterdir()] == [
        "step_00000002"]
    jcfg = BinarizerConfig(**BIN_KW)
    _, variables = jstore.init_binarizer_variables(jcfg, 5)
    params = variables["params"]
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, 1, 2)).init(params)
    step, p, o, extras = jckpt.restore_checkpoint(
        last, params, opt, extra_templates={"ema": params})
    assert step == 2 and int(o[0].count) == 2 and int(o[2].count) == 2
    _tree_equal({"p": jax.tree.map(np.asarray, p)},
                {"p": tw.read_msgpack(last / "params.msgpack")})
    _tree_equal({"p": jax.tree.map(np.asarray, extras["ema"])},
                {"p": tloop._unet_layout(cfg).to_tree(res.exported)})
    got = tw.read_msgpack(last / "opt_state.msgpack")["0"]
    _tree_equal({"mu": got["mu"], "nu": got["nu"]},
                {"mu": jax.tree.map(np.asarray, o[0].mu),
                 "nu": jax.tree.map(np.asarray, o[0].nu)})
    # A stale tmp dir is removed and a torn one is skipped.
    stale = tmp_path / "ckpt_binarizer" / "step_00000009.tmp"
    (stale / "junk").mkdir(parents=True)
    assert tckpt.latest_checkpoint(tmp_path / "ckpt_binarizer") == last
    tckpt.save_checkpoint(tmp_path / "ckpt_binarizer", 9, {}, {})
    assert not stale.exists()
    assert sorted(x.name for x in (tmp_path / "ckpt_binarizer").iterdir()
                  ) == ["step_00000002", "step_00000009"]


# ------------------------------------------------------- loop end to end

class _OneWorker(jloader.PrefetchLoader):
    def __init__(self, make_iterator, num_workers=2, prefetch=4):
        super().__init__(make_iterator, 1, prefetch)


def test_loop_matches_jax_with_one_worker_and_resumes(tmp_path,
                                                      monkeypatch):
    """Both packages' loops from the same float32 init dir, on the same
    batches (one loader worker), for 3 steps with EMA: the exported models
    agree within AdamW's bound; then each resumes the other's checkpoints
    at step 3."""
    init = tmp_path / "init"
    tw.materialize_model_dir(init, TBinarizerConfig(**BIN_KW),
                             TStrokesConfig(**SE_KW, max_length=SEQ))
    monkeypatch.setattr(jloader, "PrefetchLoader", _OneWorker)
    argv = ["--model", "both", "--steps", "3", "--batch", "2", "--seq-len",
            str(SEQ), "--init-from", str(init), "--ema", "0.9", "--lr",
            str(LR), "--coord-smoothing", "1.0", "--glyph-style", "hand",
            "--line-style", "letters", "--ckpt-every", "2"]
    assert jloop.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert tloop.main(argv + ["--out", str(tmp_path / "port"), "--device",
                              "cpu"], num_workers=1) == 0
    for f in ("binarizer", "strokes_encoder", "strokes_decoder"):
        _close_after_adamw(
            tw.read_msgpack(tmp_path / "port" / f"{f}.msgpack"),
            tw.read_msgpack(tmp_path / "jax" / f"{f}.msgpack"), LR, 3)
    for f in ("configs_binarizer.json", "configs_strokes.json"):
        assert json.loads((tmp_path / "port" / f).read_text()) == \
            json.loads((tmp_path / "jax" / f).read_text())
    for m in ("binarizer", "captioner"):
        names = sorted(p.name for p in (tmp_path / "port" / f"ckpt_{m}")
                       .iterdir())
        assert names == sorted(p.name for p in (
            tmp_path / "jax" / f"ckpt_{m}").iterdir())
        assert names == ["step_00000002", "step_00000003"]
    # Each resumes the other's run: to 5 steps, starting at 3.
    res = tloop.train(argv + ["--steps", "5", "--out", str(tmp_path / "jax"),
                              "--device", "cpu"], num_workers=1)
    for r in res.values():
        assert r.start_step == 3 and len(r.losses) == 2
        assert all(np.isfinite(r.losses))
    assert jloop.main(argv + ["--steps", "5", "--out",
                              str(tmp_path / "port")]) == 0
    for m in ("binarizer", "captioner"):
        assert (tmp_path / "port" / f"ckpt_{m}" / "step_00000005" /
                "extra_ema.msgpack").exists()


def test_loop_cli_exports_a_model_dir_both_clis_load(tmp_path, capsys):
    out = tmp_path / "out"
    assert tloop.main(["--device", "cpu", "--model", "both", "--steps", "4",
                       "--batch", "2", "--bin-features", "8",
                       "--encoder-arch", "tiny", "--se-dims", "16,16,16",
                       "--seq-len", "16", "--out", str(out)]) == 0
    b, e = cli.initialize_sessions(out, device="cpu")
    assert b.config.features == (8,) and e.config.encoder_arch == "tiny"
    jb = BinarizerConfig.from_json(out / "configs_binarizer.json")
    js = StrokesConfig.from_json(out / "configs_strokes.json")
    _, bt = jstore.binarizer_template(jb)
    jstore.load_variables(bt, out / "binarizer.msgpack")
    enc, dec = jstore.build_strokes_models(js)
    _, _, ev, dv, _ = jstore.init_strokes_variables(js, 1)
    jstore.load_variables(ev, out / "strokes_encoder.msgpack")
    jstore.load_variables(dv, out / "strokes_decoder.msgpack")
    img = np.full((40, 150, 3), 255, np.uint8)
    img[12:28, 20:60] = 0
    assert cli.run([(img, "x")], b, e, tmp_path / "cli") == 1
    res = tloop.train_binarizer(TBinarizerConfig.from_json(
        out / "configs_binarizer.json"), 6, 2, out, device="cpu",
        num_workers=1)
    assert res.start_step == 4 and len(res.losses) == 2

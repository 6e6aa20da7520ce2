"""Tests of the port that need a CUDA card (marker ``gpu``). Each decides in
its body whether a card is there and skips without one. This file imports
neither JAX nor the JAX package, so that it runs where the port runs:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder

REPO = Path(__file__).resolve().parent.parent


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stroke_derenderer_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _shipped_decoder(dtype, dev):
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    dec = AttentiveDecoder(451, 512, 512, 512, 512, dtype=dtype)
    dec.load_state_dict(tw.from_flax_decoder(tree))
    return dec.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 6])
def test_cuda_kernel_matches_plain_version(dtype, b):
    """K1 against its plain version on the shipped decoder, token for token
    (both round the float64 value of every sum once: float32 streams sum in
    float64, bfloat16 ones on the tensor cores, rechecked in float64 where
    the bound straddles a rounding), in one launch, on its stream type's
    path."""
    dev = _card()
    dt = getattr(torch, dtype)
    dec = _shipped_decoder(dt, dev)
    rng = np.random.default_rng(b)
    enc = torch.from_numpy(np.maximum(rng.normal(1.0, 1.5, (b, 196, 512)),
                                      0).astype(np.float32)).to(dev, dt)
    before = fd.launch_count
    by_path = dict(fd.engine_launches)
    got = fd.fused_greedy_decode(dec, enc, 384)
    assert fd.launch_count == before + 1
    path = fd.ENGINES[dt]
    assert fd.engine_launches == by_path | {path: by_path[path] + 1}
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    want = fd.fused_greedy_decode_plain(enc, ep, h, c, dec.weights(dt), 384)
    assert got.dtype == torch.int32 and got.shape == (b, 384)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input():
    dev = _card()
    dec = _shipped_decoder(torch.bfloat16, dev)
    enc = torch.zeros(3, 196, 512, device=dev, dtype=torch.bfloat16)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    w = dec.weights(torch.bfloat16)
    with pytest.raises(ValueError):
        fd.fused_greedy_decode_packed(enc, ep.transpose(1, 2).contiguous(),
                                      h, c, w, 8)
    with pytest.raises(TypeError):
        fd.fused_greedy_decode_packed(enc, ep, h, c,
                                      dec.weights(torch.float32), 8)
    empty = fd.fused_greedy_decode_packed(enc[:0], ep[:0], h[:0], c[:0], w, 8)
    assert empty.shape == (0, 8)


@pytest.mark.gpu
def test_cli_main_path_on_card(tmp_path):
    """The CLI's default device is the card; the golden mask agrees."""
    _card()
    from stroke_derenderer_tpu_torch.cli import entrypoint
    from stroke_derenderer_tpu_torch.io import read_png
    before = fd.launch_count
    assert entrypoint(["-models", str(REPO / "models_demo"), "-input",
                       str(REPO / "tests" / "golden"), "--output",
                       str(tmp_path)]) == 0
    assert fd.launch_count > before
    got = read_png(tmp_path / "golden_input_BINARIZED.png")
    want = read_png(REPO / "tests" / "golden" / "expected_BINARIZED.png")
    assert (got == want).mean() >= 0.999


def _enc(b, dt, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.maximum(rng.normal(1.0, 1.5, (b, 196, 512)),
                                       0).astype(np.float32)).to(dev, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3])
def test_beam_kernel_matches_plain_version(dtype, b):
    """K2 at K = 5 against its plain version on the shipped decoder: every
    beam's tokens and length identical (both sum in float64 and round once),
    scores within 1e-5 relative, in one launch."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    dt = getattr(torch, dtype)
    dec = _shipped_decoder(dt, dev)
    enc = _enc(b, dt, dev, 10 + b)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    w = dec.weights(dt)
    before = fb.launch_count
    preds, score, lens = fb.fused_beam_decode_packed(enc, ep, h, c, w, 384, 5)
    assert fb.launch_count == before + 1
    want = fb.fused_beam_decode_plain(enc, ep, h, c, w, 384, 5)
    assert preds.shape == (b, 5, 384) and preds.dtype == torch.int32
    assert torch.equal(preds.cpu(), want[0].cpu())
    assert torch.equal(lens.cpu(), want[2].cpu())
    torch.testing.assert_close(score, want[1], rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_beam_kernel_takes_every_beam_size_up_to_its_limit():
    """K = 1 gives K1's tokens; K = 16, 17 (above the old kernel's limit)
    and K = V run in one launch and match the plain version; K = V + 1
    raises."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    dec = _shipped_decoder(torch.float32, dev)
    enc = _enc(2, torch.float32, dev, 7)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    w = dec.weights(torch.float32)
    one = fb.fused_beam_decode_packed(enc, ep, h, c, w, 64, 1)[0][:, 0]
    assert torch.equal(one, fd.fused_greedy_decode_packed(enc, ep, h, c, w,
                                                          64))
    for k, steps in ((16, 16), (17, 48), (451, 6)):
        before = fb.launch_count
        preds, score, lens = fb.fused_beam_decode_packed(enc, ep, h, c, w,
                                                         steps, k)
        assert fb.launch_count == before + 1
        assert preds.shape == (2, k, steps)
        assert bool((score[:, :-1] >= score[:, 1:]).all())  # best first
        want = fb.fused_beam_decode_plain(enc, ep, h, c, w, steps, k)
        assert torch.equal(preds, want[0]) and torch.equal(lens, want[2])
        torch.testing.assert_close(score, want[1], rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="exceeds the vocabulary"):
        fb.fused_beam_decode_packed(enc, ep, h, c, w, 16, 452)


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 196), (5, 196), (3, 13)])
def test_attention_kernel_matches_plain_version(b, p):
    """K3 against its plain version with bfloat16 streams, at the cluster
    size the wrapper picks and at 8 and 16: out and alpha within 1e-5 +
    1e-4 relative (both sum in float32, in other orders), one launch per
    call, with the decoder's packed weights or without them, and with h
    in float32."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    from stroke_derenderer_tpu_torch.models.decoder import ATTENTION_WEIGHTS
    dec = _shipped_decoder(torch.bfloat16, dev)
    enc = _enc(b, torch.bfloat16, dev, 20 + b)[:, :p]
    ep, (h, _) = dec.project_encoding(enc), dec.init_state(enc)
    att_w = [getattr(dec, k) for k in ATTENTION_WEIGHTS]
    want = da.fused_attention_gate_plain(enc, ep, h, *att_w,
                                         stream_dtype=torch.bfloat16)
    packed = da.attention_weights(dec)
    for kwargs in ({}, {"packed": packed}, {"packed": packed, "cluster": 8},
                   {"packed": packed, "cluster": 16}):
        for hh in (h, h.float()):
            before = da.launch_count
            out, alpha = da.fused_attention_gate(enc, ep, hh, *att_w,
                                                 **kwargs)
            assert da.launch_count == before + 1
            torch.testing.assert_close(out, want[0], rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(alpha, want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [8, 16])
def test_attention_kernel_at_80_rows_matches_float64(cluster):
    """K3 at B = 80 against its function evaluated in float64 (bfloat16
    streams, b_v dropped), within 1e-5 + 1e-4 relative. On these inputs the
    scores lie near -790, so each float32 order of the sums (the kernel's,
    or the plain version's) is up to ~1.5e-4 relative from the exact value,
    and two of them can be twice that apart: the exact value is the
    yardstick here (measured on an H100: the plain version itself misses
    this bar at one element)."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    from stroke_derenderer_tpu_torch.models.decoder import ATTENTION_WEIGHTS
    dec = _shipped_decoder(torch.bfloat16, dev)
    enc = _enc(80, torch.bfloat16, dev, 100)
    ep, (h, _) = dec.project_encoding(enc), dec.init_state(enc)
    att_w = [getattr(dec, k) for k in ATTENTION_WEIGHTS]
    x = [t.to(torch.bfloat16).double() for t in (enc, ep, h, *att_w)]
    enc64, ep64, h64, w_att, b_att, v, _, w_f, b_f = x
    alpha = torch.softmax(torch.relu(ep64 + (h64 @ w_att + b_att)[:, None])
                          @ v, dim=1)
    out = torch.sigmoid(h64 @ w_f + b_f) * torch.bmm(alpha[:, None],
                                                     enc64)[:, 0]
    before = da.launch_count
    got = da.fused_attention_gate(enc, ep, h, *att_w,
                                  packed=da.attention_weights(dec),
                                  cluster=cluster)
    assert da.launch_count == before + 1
    for g, w in zip(got, (out, alpha)):
        torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_attention_kernel_matches_split_emulation():
    """The kernel and its emulation on the CPU take the same plan: at a
    narrow width with more CTAs than positions they agree within the same
    bar."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    rng = np.random.default_rng(5)
    b, p, e, a, d = 6, 9, 16, 24, 12
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    args = [f(b, p, e), f(b, p, a), f(b, d), f(d, a), f(a), f(a), f(1),
            f(d, e), f(e)]
    cpu = da.fused_attention_gate_split(*args[:3], da.pack_attention_weights(
        args[3], args[4], args[5], args[7], args[8]), 16)
    got = da.fused_attention_gate(*(t.to(dev) for t in args), cluster=16)
    for g, w in zip(got, cpu):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_attention_wrapper_raises_without_fallback():
    """A width the kernel does not take and a tensor on the CPU beside CUDA
    ones raise; nothing falls back to the plain version, nothing launches;
    B = 0 returns empty outputs without a launch."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev)
    args = [f(2, 9, 20), f(2, 9, 24), f(2, 12), f(12, 24), f(24), f(24),
            f(1), f(12, 20), f(20)]
    before = da.launch_count
    with pytest.raises(ValueError, match="E=20"):
        da.fused_attention_gate(*args)
    good = [f(2, 9, 16), args[1], args[2], args[3], args[4], args[5],
            args[6], f(12, 16), f(16)]
    for i in range(len(good)):
        mixed = list(good)
        mixed[i] = mixed[i].cpu()
        with pytest.raises(ValueError):
            da.fused_attention_gate(*mixed)
    assert da.launch_count == before
    out, alpha = da.fused_attention_gate(*(t[:0] if t.dim() > 1 and
                                           t.shape[0] == 2 else t
                                           for t in good))
    assert out.shape == (0, 16) and alpha.shape == (0, 9)
    assert da.launch_count == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_attention_greedy_launches_once_per_step(dtype):
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    from stroke_derenderer_tpu_torch.models.decoder import greedy_decode
    dec = _shipped_decoder(getattr(torch, dtype), dev)
    enc = _enc(3, getattr(torch, dtype), dev, 30)
    before = da.launch_count
    preds = greedy_decode(dec, enc, 40, fused=True)
    is_eos = (preds == 2).cpu()
    steps = int(max(int(r.nonzero()[0]) + 1 if r.any() else 40
                    for r in is_eos))
    assert da.launch_count - before == steps


@pytest.mark.gpu
def test_cli_beam_path_on_card(tmp_path):
    """--decode beam on the card: K2 launches once per image with glyphs,
    K1 not at all; the golden mask agrees."""
    _card()
    from stroke_derenderer_tpu_torch.cli import entrypoint
    from stroke_derenderer_tpu_torch.io import read_png
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    before, before_k1 = fb.launch_count, fd.launch_count
    assert entrypoint(["-models", str(REPO / "models_demo"), "-input",
                       str(REPO / "tests" / "golden"), "--output",
                       str(tmp_path), "--decode", "beam", "--beam-size",
                       "5"]) == 0
    with_glyphs = sum(bool(read_png(p).any())
                      for p in tmp_path.glob("*_BINARIZED.png"))
    assert with_glyphs >= 1
    assert fb.launch_count - before == with_glyphs
    assert fd.launch_count == before_k1
    assert (tmp_path / "golden_input_STROKES.json").exists()
    got = read_png(tmp_path / "golden_input_BINARIZED.png")
    want = read_png(REPO / "tests" / "golden" / "expected_BINARIZED.png")
    assert (got == want).mean() >= 0.999


@pytest.mark.gpu
def test_cli_beam_of_17_on_card(tmp_path):
    """--beam-size 17 (above the old kernel's limit of 16) on the card:
    every image with glyphs gets its strokes, through K2."""
    _card()
    import json
    from stroke_derenderer_tpu_torch.cli import entrypoint
    from stroke_derenderer_tpu_torch.io import read_png
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    before = fb.launch_count
    assert entrypoint(["-models", str(REPO / "models_demo"), "-input",
                       str(REPO / "tests" / "golden"), "--output",
                       str(tmp_path), "--decode", "beam", "--beam-size",
                       "17"]) == 0
    with_glyphs = [p for p in tmp_path.glob("*_BINARIZED.png")
                   if read_png(p).any()]
    assert with_glyphs
    assert fb.launch_count - before == len(with_glyphs)
    for p in with_glyphs:
        stem = p.name[:-len("_BINARIZED.png")]
        strokes = json.loads((tmp_path / f"{stem}_STROKES.json").read_text())
        assert strokes


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_the_batched_shapes(dtype):
    """K1 at 200 rows and K2 at 200 images x 5 beams (1,000 rows), the
    shapes of the cross-image batched path, against their plain versions:
    tokens and lengths identical, scores within 1e-5 relative, one launch
    each."""
    dev = _card()
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    dt = getattr(torch, dtype)
    dec = _shipped_decoder(dt, dev)
    enc = _enc(200, dt, dev, 40)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    w = dec.weights(dt)
    before = fd.launch_count
    got = fd.fused_greedy_decode_packed(enc, ep, h, c, w, 384)
    assert fd.launch_count == before + 1
    want = fd.fused_greedy_decode_plain(enc, ep, h, c, w, 384)
    assert torch.equal(got, want)
    before = fb.launch_count
    preds, score, lens = fb.fused_beam_decode_packed(enc, ep, h, c, w, 160, 5)
    assert fb.launch_count == before + 1
    r_preds, r_score, r_lens = fb.fused_beam_decode_plain(enc, ep, h, c, w,
                                                          160, 5)
    assert preds.shape == (200, 5, 160)
    assert torch.equal(preds, r_preds) and torch.equal(lens, r_lens)
    torch.testing.assert_close(score, r_score, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_cli_batch_on_card(tmp_path, decode):
    """--batch on the card: one launch of the path's kernel for the whole
    input folder and none of the other; the golden mask agrees, and the
    masks are the per-image run's."""
    _card()
    from stroke_derenderer_tpu_torch.cli import entrypoint
    from stroke_derenderer_tpu_torch.io import read_png
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    args = ["-models", str(REPO / "models_demo"), "-input",
            str(REPO / "tests" / "golden"), "--decode", decode]
    before = (fd.launch_count, fb.launch_count)
    assert entrypoint(args + ["--output", str(tmp_path / "b"),
                              "--batch"]) == 0
    launched = (fd.launch_count - before[0], fb.launch_count - before[1])
    assert launched == ((1, 0) if decode == "greedy" else (0, 1))
    assert entrypoint(args + ["--output", str(tmp_path / "a")]) == 0
    for p in (tmp_path / "a").glob("*_BINARIZED.png"):
        assert (read_png(p) == read_png(tmp_path / "b" / p.name)).mean() \
            >= 0.9999
        assert (tmp_path / "b" / p.name.replace(
            "_BINARIZED.png", "_STROKES.json")).exists()
    got = read_png(tmp_path / "b" / "golden_input_BINARIZED.png")
    want = read_png(REPO / "tests" / "golden" / "expected_BINARIZED.png")
    assert (got == want).mean() >= 0.999


@pytest.mark.gpu
def test_server_on_card():
    """The server's default device is the card: concurrent /derender
    requests are answered from fewer K1 launches than requests."""
    _card()
    import http.client
    import json
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer
    from stroke_derenderer_tpu_torch import serve
    from stroke_derenderer_tpu_torch.cli import initialize_sessions
    binarizer, estimator = initialize_sessions(REPO / "models_demo")
    assert binarizer.device.type == "cuda"
    worker = serve.BatchWorker(binarizer, estimator, window_s=0.2)
    worker.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(worker))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    body = (REPO / "tests" / "golden" / "golden_input.png").read_bytes()

    def post(_):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=300)
        try:
            conn.request("POST", "/derender", body=body)
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    try:
        before = fd.launch_count
        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(post, range(4)))
        launched = fd.launch_count - before
    finally:
        srv.shutdown()
        srv.server_close()
        worker.close()
        worker.join(60)
    assert [s for s, _ in replies] == [200] * 4
    assert all(out["strokes"] for _, out in replies)
    assert 0 < launched < 4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [[], ["--batch"], ["--decode", "beam"]],
                         ids=["per-image", "batch", "beam"])
def test_cli_preset_real_on_card(tmp_path, mode):
    """--preset real on the card: the first pass and each residual pass are
    one launch of the path's kernel per image, or for the whole folder with
    --batch; the golden image needs at least one residual pass, and its
    mask agrees."""
    _card()
    from stroke_derenderer_tpu_torch.cli import entrypoint
    from stroke_derenderer_tpu_torch.io import read_png
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    mod = fb if "beam" in mode else fd
    inputs = len(list((REPO / "tests" / "golden").glob("*.png")))
    before = mod.launch_count
    assert entrypoint(["-models", str(REPO / "models_demo"), "-input",
                       str(REPO / "tests" / "golden"), "--output",
                       str(tmp_path), "--preset", "real"] + mode) == 0
    launched = mod.launch_count - before
    if "--batch" in mode:
        assert 2 <= launched <= 1 + 3
    else:
        assert inputs + 1 <= launched <= inputs * (1 + 3)
    got = read_png(tmp_path / "golden_input_BINARIZED.png")
    want = read_png(REPO / "tests" / "golden" / "expected_BINARIZED.png")
    assert (got == want).mean() >= 0.999
    assert (tmp_path / "golden_input_STROKES.json").exists()


@pytest.mark.gpu
def test_eval_runner_on_card(capsys):
    """The evaluator runs on the card by default and prints one JSON line
    with the JAX evaluator's keys."""
    _card()
    import json
    from stroke_derenderer_tpu_torch.eval.run import main
    before = fd.launch_count
    assert main(["--models", str(REPO / "models_demo"), "--n", "3",
                 "--style", "mixed", "--redecode", "0.9"]) == 0
    assert fd.launch_count > before
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 3 and 0.0 <= out["stroke_coverage"] <= 1.0
    assert {"stroke_dtw", "stroke_dtw_ci95", "stroke_chamfer",
            "binarization_f1"} <= set(out)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["binarizer", "captioner"])
def test_train_step_on_card(model):
    """One float32 update step of a shipped model on the card against the
    same step on the CPU, on the same batch: the loss within 1e-5
    (relative), every parameter's gradient within 1e-3 of its largest
    value (cuDNN's and the CPU's float32 reductions take other orders: the
    worst leaf measured on an H100 was 3.3e-4, a GroupNorm bias), and the
    parameters after the update within AdamW's bound for one step (2 * lr:
    a gradient near zero may round to the other sign)."""
    import dataclasses
    dev = _card()
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.data.synthetic import (
        partitioned_glyph_batches, tile_batches,
    )
    from stroke_derenderer_tpu_torch.train import loop, steps
    models = REPO / "models_demo"
    lr = 1e-4
    if model == "binarizer":
        batch = next(tile_batches(np.random.default_rng(1), 2,
                                  style="letters"))
    else:
        batch = next(partitioned_glyph_batches(np.random.default_rng(1), 2,
                                               48, style="hand"))

    def run(device):
        up = lambda a: torch.from_numpy(a).to(device)
        if model == "binarizer":
            cfg = dataclasses.replace(BinarizerConfig.from_json(
                models / "configs_binarizer.json"), compute_dtype="float32")
            module = tw.init_binarizer(cfg)
            layout = loop._unet_layout(cfg)
            module.load_state_dict(layout.from_tree(tw.read_msgpack(
                models / "binarizer.msgpack")["params"]))
            module.to(device)
            update = steps.make_binarizer_train_step(
                module, steps.make_optimizer(module), lambda c: lr)
            loss = float(update(*(up(a) for a in batch)))
        else:
            cfg = dataclasses.replace(StrokesConfig.from_json(
                models / "configs_strokes.json"), compute_dtype="float32")
            module = steps.Captioner(*tw.init_strokes(cfg))
            layout = loop._captioner_layout(cfg)
            module.load_state_dict(layout.from_tree({
                k: tw.read_msgpack(models / f"strokes_{k}.msgpack")["params"]
                for k in ("encoder", "decoder")}))
            module.decoder.requires_grad_(True)
            module.to(device)
            update = steps.make_captioner_train_step(
                module, steps.make_optimizer(module), lambda c: lr,
                coord_sigma=1.0)
            crops, tin, tout = batch
            loss = float(update(up(crops), up(tin).long(), up(tout).long()))
        return loss, {k: (p.grad.cpu(), p.detach().cpu())
                      for k, p in module.named_parameters()}

    (card_loss, card), (cpu_loss, cpu) = run(dev), run("cpu")
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for k, (g, p) in cpu.items():
        gc, pc = card[k]
        # The softmax over positions ignores a shift of the scores, so the
        # gradient of decoder.bv is zero up to rounding on both sides.
        if k != "decoder.bv":
            assert float((gc - g).abs().max()) <= 1e-3 * float(
                g.abs().max()), k
        assert float((pc - p).abs().max()) <= 2 * lr + 1e-6, k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_at_encoder_width_2048(dtype):
    """K1 against its plain version on a random decoder that reads a
    ResNet-50's 2048 features (no projection), token for token."""
    dev = _card()
    from stroke_derenderer_tpu_torch.config import StrokesConfig
    dt = getattr(torch, dtype)
    _, dec = tw.init_strokes(StrokesConfig(encoder_arch="resnet50",
                                           compute_dtype=dtype), seed=3)
    dec = dec.to(dev)
    assert dec.enc_att_w.shape[0] == 2048
    rng = np.random.default_rng(4)
    enc = torch.from_numpy(np.maximum(rng.normal(0.5, 1.0, (4, 196, 2048)),
                                      0).astype(np.float32)).to(dev, dt)
    before = fd.launch_count
    got = fd.fused_greedy_decode(dec, enc, 384)
    assert fd.launch_count == before + 1
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    want = fd.fused_greedy_decode_plain(enc, ep, h, c, dec.weights(dt), 384)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.gpu
def test_cli_on_an_onnx_dir_on_card(tmp_path):
    """``--export-onnx`` of ``models_demo``, then the CLI on the exported
    dir on the card: imported on the fly, K1 launched, the golden mask."""
    _card()
    from stroke_derenderer_tpu_torch.cli import entrypoint
    from stroke_derenderer_tpu_torch.io import read_png
    assert entrypoint(["-models", str(REPO / "models_demo"), "--export-onnx",
                       str(tmp_path / "onnx")]) == 0
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "golden_input.png").write_bytes(
        (REPO / "tests" / "golden" / "golden_input.png").read_bytes())
    before = fd.launch_count
    assert entrypoint(["-models", str(tmp_path / "onnx"), "-input",
                       str(tmp_path / "in"), "--output",
                       str(tmp_path / "out")]) == 0
    assert fd.launch_count == before + 1
    got = read_png(tmp_path / "out" / "golden_input_BINARIZED.png")
    want = read_png(REPO / "tests" / "golden" / "expected_BINARIZED.png")
    assert (got == want).mean() >= 0.999


# (batch, in, height, width, out, kernel, stride, pad): the UNet's 3x3 and
# 1x1 gate convolutions, the encoder's stem, stride-2 3x3 and 1x1 proj.
INT8_SHAPES = [(4, 16, 64, 96, 32, 3, 1, 1), (4, 128, 16, 24, 128, 3, 1, 1),
               (4, 16, 64, 96, 8, 1, 1, 0), (8, 3, 224, 224, 64, 7, 2, 3),
               (8, 64, 56, 56, 128, 3, 2, 1), (8, 64, 56, 56, 128, 1, 2, 0),
               (1, 8, 3, 4, 8, 1, 1, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_on_card_equals_cpu(dtype):
    """``int8_conv2d`` on the card (im2col, ``torch._int_mm`` in cuBLASLt)
    against the same function on the CPU: the int32 sums equal and the
    outputs bit for bit the same."""
    dev = _card()
    from stroke_derenderer_tpu_torch.ops import quant
    rng = np.random.default_rng(0)
    for b, cin, h, w, cout, k, s, p in INT8_SHAPES:
        x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(
            np.float32)).to(dtype)
        wt = torch.from_numpy((rng.normal(size=(cout, cin, k, k)) * 0.1)
                              .astype(np.float32)).to(dtype)
        xq, _ = quant._quantize(x)
        wq, _ = quant._quantize(wt, (1, 2, 3))
        assert torch.equal(quant.conv2d_int32(xq.to(dev), wq.to(dev), s,
                                              p).cpu(),
                           quant.conv2d_int32(xq, wq, s, p))
        got = quant.int8_conv2d(x.to(dev), wt.to(dev), s, p)
        assert got.is_cuda and got.dtype == dtype
        assert torch.equal(got.cpu(), quant.int8_conv2d(x, wt, s, p))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_two_stage_on_card_matches_sequential_chunks(quant):
    """``TwoStagePipeline.process_batched`` on the card (each stage on its
    own stream) against ``binarize_images`` + ``process_images`` over the
    same chunks: the same masks and strokes, one K1 launch per chunk."""
    dev = _card()
    from stroke_derenderer_tpu_torch import cli
    from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline
    ov = {"quant": quant}
    binarizer, estimator = cli.initialize_sessions(
        REPO / "models_demo", device=dev, se_overrides=ov, bin_overrides=ov)
    paths = sorted(p for p in (REPO / "data_pseudo_real").glob("*.png")
                   if not p.stem.endswith("_BINARIZED"))[:7]
    imgs = [img for img, _ in cli.load_images(paths)]
    seq_masks, seq_strokes = [], []
    for c in range(0, len(imgs), 3):
        masks = [b[:, :, 0] > 127
                 for b in binarizer.binarize_images(imgs[c:c + 3])]
        seq_masks += masks
        seq_strokes += estimator.process_images(masks)
    before = fd.launch_count
    masks, strokes = TwoStagePipeline(binarizer, estimator).process_batched(
        imgs, chunk_size=3)
    assert fd.launch_count - before == 3
    for a, b in zip(seq_masks, masks):
        assert np.array_equal(a, b)
    for a, b in zip(seq_strokes, strokes):
        assert len(a) == len(b)
        for (ax, ay), (bx, by) in zip(a, b):
            assert np.array_equal(ax, bx) and np.array_equal(ay, by)


@pytest.mark.gpu
@pytest.mark.parametrize("name,k", [("fused_decode", 1), ("fused_beam", 5)])
def test_tensor_core_bound_holds(name, k):
    """K1 and K2 on bfloat16 streams at 80 rows: some elements are
    recomputed in float64, and among them the tensor-core sums stay within
    their bound (the largest error as a share of it below 1); the kernels'
    SASS holds HMMA in the bfloat16 instantiation only."""
    dev = _card()
    import re
    import subprocess
    from stroke_derenderer_tpu_torch.kernels import build
    dec = _shipped_decoder(torch.bfloat16, dev)
    enc = _enc(80 // k, torch.bfloat16, dev, 60)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    b = enc.shape[0]
    fixstat = torch.zeros((1024, 2), dtype=torch.int32, device=dev)
    fd.launch_step_kernel(name, enc, ep.contiguous(), h.contiguous(),
                          c.contiguous(), fd.step_weights(dec, torch.bfloat16),
                          k, 384, {
                              "preds": torch.zeros((b, k, 384),
                                                   dtype=torch.int32,
                                                   device=dev),
                              "score_out": torch.zeros((b, k), device=dev),
                              "lens_out": torch.zeros((b, k),
                                                      dtype=torch.int32,
                                                      device=dev),
                              "fixstat": fixstat})
    torch.cuda.synchronize()
    stat = fixstat.cpu()
    assert int(stat[:, 0].sum()) > 0
    assert 0 < float(stat[:, 1].view(torch.float32).max()) < 1
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.BUILD /
                                                    f"lib{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    per_fn = re.split(r"Function : ", sass)[1:]
    hmma = {f.split()[0]: len(re.findall(r"\bHMMA\b", f)) for f in per_fn}
    assert any(n > 0 for f, n in hmma.items() if "I13__nv_bfloat16E" in f)
    assert all(n == 0 for f, n in hmma.items() if "IfEEv" in f)

"""Beam decode and K2: the port's plain beam search against the JAX
``beam_decode`` and the Pallas kernel run in interpret mode, the pipeline
and the CLI with ``decode="beam"`` against the JAX package, and the kernel
wrapper's routing and argument checks. The CUDA kernel itself is tested on
a card by ``test_torch_gpu.py``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.kernels.fused_beam import _fused_beam_decode_tpu
from stroke_derenderer_tpu.kernels.fused_decode import pack_decoder_weights
from stroke_derenderer_tpu.models import AttentiveDecoder as JDecoder
from stroke_derenderer_tpu.models import beam_decode as j_beam
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import EOS, PAD
from stroke_derenderer_tpu_torch.config import StrokesConfig as TStrokesConfig
from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
from stroke_derenderer_tpu_torch.models.decoder import (
    AttentiveDecoder, beam_decode, greedy_decode,
)

REPO = Path(__file__).resolve().parent.parent


def _tiny(seed, eos_bias, width=16, vocab=51, e=16):
    """A tiny float32 decoder; ``eos_bias`` raises the EOS logit so that
    beams finish at different steps."""
    jd = JDecoder(vocab_size=vocab, embed_dim=width, attention_dim=width,
                  decoder_dim=width, encoder_dim=e, dtype=jnp.float32)
    v = jd.init(jax.random.PRNGKey(seed), jnp.zeros((1, 9, e)),
                jnp.zeros((1, 3), jnp.int32))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, v)
    v["params"]["fc"]["bias"][EOS] += eos_bias
    td = AttentiveDecoder(vocab, width, width, width, e, dtype=torch.float32)
    td.load_state_dict(tw.from_flax_decoder(v))
    return jd, v, td


def _enc(seed, b):
    return np.random.default_rng(seed).normal(size=(b, 9, 16)).astype(
        np.float32)


# (seed, B, eos_bias, K, length_penalty); seeds 3 and 5 are cases where
# the penalty changes which beam wins.
CASES = [(0, 5, 1.0, 1, 0.0), (1, 3, 1.0, 1, 0.7), (2, 5, 1.0, 3, 0.0),
         (3, 5, 0.5, 3, 0.0), (3, 5, 0.5, 3, 0.7), (4, 7, 1.0, 5, 0.0),
         (5, 5, 1.0, 5, 0.0), (5, 5, 1.0, 5, 0.7)]


@pytest.mark.parametrize("seed,b,eos_bias,k,lp", CASES)
def test_beam_tokens_match_jax(seed, b, eos_bias, k, lp):
    """float32: the plain beam_decode and the kernel entry (its plain
    version on the CPU) give JAX beam_decode's tokens, for a ragged batch
    whose beams finish at different steps."""
    jd, v, td = _tiny(seed, eos_bias)
    enc = _enc(seed, b)
    want = np.asarray(j_beam(jd, v, jnp.asarray(enc), 30, beam_size=k,
                             length_penalty=lp))
    got = beam_decode(td, torch.from_numpy(enc), 30, k, lp).numpy()
    assert got.dtype == np.int32 and got.shape == (b, 30)
    np.testing.assert_array_equal(got, want)
    before = fb.launch_count
    fused = fb.fused_beam_decode(td, torch.from_numpy(enc), 30, k, lp)
    assert fb.launch_count == before  # the CPU runs the plain version
    np.testing.assert_array_equal(fused.numpy(), want)


def test_length_penalty_changes_the_choice():
    _, _, td = _tiny(3, 0.5)
    enc = torch.from_numpy(_enc(3, 5))
    assert not torch.equal(beam_decode(td, enc, 30, 3, 0.0),
                           beam_decode(td, enc, 30, 3, 0.7))


@pytest.mark.parametrize("seed,b,k", [(1, 3, 4), (6, 2, 5)])
def test_raw_outputs_match_interpret_kernel(seed, b, k):
    """Every beam's tokens, score and length against the Pallas K2 in
    interpret mode: tokens and lengths identical, scores within 1e-5
    relative (the log-softmax sums in another order)."""
    jd, v, td = _tiny(seed, 1.0)
    enc = _enc(seed, b)
    jenc = jnp.asarray(enc)
    apply = lambda m, *a: jd.apply(v, *a, method=m)
    jh, jc = apply(JDecoder.init_state, jenc)
    want = _fused_beam_decode_tpu(
        jenc, apply(JDecoder.project_encoding, jenc), jh, jc,
        pack_decoder_weights(v["params"]), 30, k, interpret=True,
        stream_dtype="float32")
    tenc = torch.from_numpy(enc)
    h, c = td.init_state(tenc)
    preds, score, lens = fb.fused_beam_decode_plain(
        tenc, td.project_encoding(tenc), h, c, td.weights(torch.float32), 30,
        k)
    assert (preds.dtype, score.dtype, lens.dtype) == (
        torch.int32, torch.float32, torch.int32)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(score.numpy(), np.asarray(want[1]), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_beam_of_one_is_greedy(seed):
    _, _, td = _tiny(seed, 0.5)
    enc = torch.from_numpy(_enc(seed, 5))
    assert torch.equal(beam_decode(td, enc, 30, 1),
                       greedy_decode(td, enc, 30))


def test_beams_write_pad_after_eos():
    """Every beam writes its tokens up to and including its EOS and PAD
    after it; its length counts them; its score is a sum of
    log-probabilities, so no larger than 0."""
    _, _, td = _tiny(2, 1.5)
    enc = torch.from_numpy(_enc(2, 4))
    h, c = td.init_state(enc)
    preds, score, lens = fb.fused_beam_decode_plain(
        enc, td.project_encoding(enc), h, c, td.weights(torch.float32), 30, 4)
    finished = 0
    for row, n in zip(preds.reshape(-1, 30).numpy(), lens.flatten().numpy()):
        hits = np.flatnonzero(row == EOS)
        if hits.size:
            finished += 1
            assert n == hits[0] + 1
            assert (row[:n] != PAD).all() and (row[n:] == PAD).all()
        else:
            assert n == 30 and (row != PAD).all()
    assert finished > 0
    assert (score <= 0).all()


def test_shipped_decoder_beam_matches_jax_float32():
    """The shipped decoder weights at full width (E = A = H = D = 512,
    V = 451), run in float32 at K = 5: identical tokens to JAX
    beam_decode."""
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    jd = JDecoder(vocab_size=451, embed_dim=512, attention_dim=512,
                  decoder_dim=512, encoder_dim=512, dtype=jnp.float32)
    td = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.float32)
    td.load_state_dict(tw.from_flax_decoder(tree))
    rng = np.random.default_rng(0)
    enc = np.maximum(rng.normal(1.0, 1.5, size=(2, 196, 512)), 0).astype(
        np.float32)
    want = np.asarray(j_beam(jd, tree, jnp.asarray(enc), 24, beam_size=5))
    got = fb.fused_beam_decode(td, torch.from_numpy(enc), 24, 5).numpy()
    np.testing.assert_array_equal(got, want)


TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=24, compute_dtype="float32")


def _line_mask(w=600, h=128):
    img = np.zeros((h, w), bool)
    for k in range(4):
        t = np.linspace(0, 4 * np.pi, 300)
        xs = (60 + k * (w - 120) // 4 + 30 * np.cos(t)).astype(int)
        ys = (h // 2 + 40 * np.sin(t)).astype(int)
        img[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = True
    return img


def test_estimator_beam_matches_jax(tmp_path):
    """StrokeEstimator with decode="beam" (given as the CLI's overrides) on
    a tiny float32 model: the same strokes as the JAX estimator."""
    materialize_model_dir(tmp_path, TINY_BIN, TINY_SE)
    overrides = {"decode": "beam", "beam_size": 3}
    _, j_est = j_cli.initialize_sessions(tmp_path, se_overrides=overrides)
    _, est = cli.initialize_sessions(tmp_path, device="cpu",
                                     se_overrides=overrides)
    assert (est.config.decode, est.config.beam_size) == ("beam", 3)
    mask = _line_mask()
    want = j_est.process_image(mask)
    got = est.process_image(mask)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    greedy = cli.initialize_sessions(tmp_path, device="cpu")[1]
    beam1 = cli.initialize_sessions(tmp_path, device="cpu", se_overrides={
        "decode": "beam", "beam_size": 1})[1]
    for (gx, gy), (bx, by) in zip(greedy.process_image(mask),
                                  beam1.process_image(mask)):
        np.testing.assert_array_equal(gx, bx)
        np.testing.assert_array_equal(gy, by)


def test_cli_decode_flags(tmp_path, capsys, monkeypatch):
    """--decode beam --beam-size K reach the estimator; the run writes every
    output; an unknown decode mode is refused."""
    materialize_model_dir(tmp_path / "m", TINY_BIN, TINY_SE)
    args = cli.parse_args(["-models", "m", "--decode", "beam",
                           "--beam-size", "3"])
    assert (args.decode, args.beam_size) == ("beam", 3)
    seen = {}
    real = cli.initialize_sessions

    def spy(*a, **k):
        seen.update(k["se_overrides"])
        return real(*a, **k)

    monkeypatch.setattr(cli, "initialize_sessions", spy)
    assert cli.entrypoint(
        ["-models", str(tmp_path / "m"), "-input", str(REPO / "tests" /
                                                       "golden"),
         "--output", str(tmp_path / "out"), "--device", "cpu", "--decode",
         "beam", "--beam-size", "3"]) == 0
    assert seen == {"decode": "beam", "beam_size": 3}
    assert "[error]" not in capsys.readouterr().out
    assert (tmp_path / "out" / "golden_input_STROKES.json").exists()
    with pytest.raises(ValueError, match="decode must be"):
        real(tmp_path / "m", device="cpu", se_overrides={"decode": "top"})


def test_wrapper_routes_cpu_only_and_checks():
    _, _, td = _tiny(0, 0.0)
    enc = torch.from_numpy(_enc(0, 2))
    ep, (h, c) = td.project_encoding(enc), td.init_state(enc)
    w = td.weights(torch.float32)
    before = fb.launch_count
    got = fb.fused_beam_decode_packed(enc, ep, h, c, w, 12, 3)
    assert fb.launch_count == before
    want = fb.fused_beam_decode_plain(enc, ep, h, c, w, 12, 3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    meta = [t.to("meta") for t in (enc, ep, h, c)]
    with pytest.raises(ValueError, match="no fused beam decode"):
        fb.fused_beam_decode_packed(*meta, w, 12, 3)
    with pytest.raises(ValueError, match="at least 1"):
        fb.fused_beam_decode_plain(enc, ep, h, c, w, 12, 0)
    v = w["emb"].shape[0]
    for k in (1, 17, v):  # consistent inputs pass: any K from 1 to V
        fb._check_beam(enc, ep, h, c, w, k)
    with pytest.raises(ValueError, match="at least 1"):
        fb._check_beam(enc, ep, h, c, w, 0)
    with pytest.raises(ValueError, match="exceeds the vocabulary"):
        fb._check_beam(enc, ep, h, c, w, v + 1)
    small = dict(w, emb=w["emb"][:4], wfc=w["wfc"][:, :4].contiguous(),
                 bfc=w["bfc"][:4])
    with pytest.raises(ValueError, match="exceeds the vocabulary"):
        fb._check_beam(enc, ep, h, c, small, 5)
    with pytest.raises(ValueError):
        fb._check_beam(enc, ep[:, :5], h, c, w, 3)


def test_top_k_breaks_ties_to_the_lowest_index():
    flat = torch.tensor([[0.0, 3.0, 1.0, 3.0, fb.NEG_INF, 3.0],
                         [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = fb.top_k_lowest(flat, 4)
    assert idx.tolist() == [[1, 3, 5, 2], [0, 1, 2, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0]]
    assert flat[0, 1] == 3.0  # the input is not modified


def test_select_beam_penalty_and_ties():
    preds = torch.arange(2 * 3 * 4, dtype=torch.int32).view(2, 3, 4)
    score = torch.tensor([[-2.0, -1.0, -1.0], [-6.0, -5.0, -7.0]])
    lens = torch.tensor([[1, 1, 1], [9, 1, 15]], dtype=torch.int32)
    assert torch.equal(fb.select_beam(preds, score, lens),
                       preds[[0, 1], [1, 1]])
    # ((5 + len) / 6) ** 1: -6 / 2.33 = -2.57, -5 / 1 = -5, -7 / 3.33 = -2.1
    assert torch.equal(fb.select_beam(preds, score, lens, 1.0),
                       preds[[0, 1], [1, 2]])


def test_config_fields_and_unsupported_options(tmp_path):
    materialize_model_dir(tmp_path, TINY_BIN, TINY_SE)
    # int8 is ported: the estimator builds its int8 encoder (its numbers:
    # tests/test_torch_quant.py).
    _, est = cli.initialize_sessions(tmp_path, device="cpu",
                                     se_overrides={"quant": "int8",
                                                   "decode": "beam"})
    assert est.encoder.quant == "int8" and est.config.decode == "beam"
    ours, theirs = TStrokesConfig(), StrokesConfig()
    assert (ours.decode, ours.beam_size, ours.length_penalty) == (
        theirs.decode, theirs.beam_size, theirs.length_penalty)


@pytest.mark.parametrize("k", [0, 52])
def test_wrapper_raises_outside_one_to_v(k):
    """Every K from 1 to V is taken (no other limit); K < 1 and K > V
    raise, on the CPU as on the card."""
    _, _, td = _tiny(0, 0.0)  # V = 51
    enc = torch.from_numpy(_enc(0, 2))
    ep, (h, c) = td.project_encoding(enc), td.init_state(enc)
    with pytest.raises(ValueError, match="at least 1"):
        fb.fused_beam_decode_packed(enc, ep, h, c, td.weights(torch.float32),
                                    6, k)


def test_beam_of_the_whole_vocabulary_runs_on_cpu():
    _, _, td = _tiny(1, 1.0)  # V = 51
    enc = torch.from_numpy(_enc(1, 2))
    ep, (h, c) = td.project_encoding(enc), td.init_state(enc)
    preds, score, lens = fb.fused_beam_decode_packed(
        enc, ep, h, c, td.weights(torch.float32), 4, 51)
    assert preds.shape == (2, 51, 4)
    assert bool((score[:, :-1] >= score[:, 1:]).all())  # best first


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("k", [1, 5, 17])
def test_launch_hands_the_engine_beam_state(monkeypatch, grid, k):
    """K2's launch on the host side: K in the dims, every pointer set, the
    beam state and back-pointers sized for B x K rows, each block's row
    list for all of them."""
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from test_torch_decode import fake_launch
    entry = fake_launch(monkeypatch, grid)
    sizes = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes[t.data_ptr()] = tuple(t.shape)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    _, _, td = _tiny(0, 0.0, vocab=51)
    b = 3
    enc = torch.zeros(b, 9, 16)
    ep, (h, c) = td.project_encoding(enc), td.init_state(enc)
    out = {"preds": torch.full((b, k, 12), PAD, dtype=torch.int32),
           "score_out": torch.zeros(b, k), "lens_out": torch.zeros(
               b, k, dtype=torch.int32)}
    fd.launch_step_kernel("fused_beam", enc, ep, h, c,
                          fd.pack_step_weights(td.weights(torch.float32)), k,
                          12, out)
    _, ptrs, dims, got_grid = entry.calls[0]
    assert got_grid == grid and dims[fd.STEP_DIMS.index("K")] == k
    got = dict(zip(fd.STEP_POINTERS, ptrs))
    assert [n for n, v in got.items() if v is None] == ["stamps",
                                                        *fd.MMA_ONLY]
    shape = lambda n: sizes[got[n]]
    assert shape("bp_parent") == shape("bp_write") == (b, 12, k)
    for n in ("tok", "parent", "score", "fin", "len"):
        assert shape(n) == (b * k,)
    assert shape("done") == shape("steps") == (b,)
    assert shape("rows") == (grid, 2 * b * k)
    assert shape("h") == (2, b * k, 16) and shape("logits") == (b * k, 51)

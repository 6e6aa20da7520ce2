"""Greedy decode and K1: the port's plain decode against the JAX
``greedy_decode`` and the Pallas kernel run in interpret mode, the kernel
wrapper's routing and argument checks, and the build lock. The CUDA kernel
itself is tested on a card by ``test_torch_gpu.py``."""

import fcntl
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu.kernels import fused_greedy_decode as j_fused
from stroke_derenderer_tpu.models import AttentiveDecoder as JDecoder
from stroke_derenderer_tpu.models import greedy_decode as j_greedy
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import EOS, PAD
from stroke_derenderer_tpu_torch.kernels import build
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.decoder import (
    AttentiveDecoder, greedy_decode,
)

REPO = Path(__file__).resolve().parent.parent


def _tiny(seed, eos_bias, width=16, vocab=51, e=16):
    """A tiny float32 decoder; ``eos_bias`` raises the EOS logit so that
    rows retire at different steps."""
    jd = JDecoder(vocab_size=vocab, embed_dim=width, attention_dim=width,
                  decoder_dim=width, encoder_dim=e, dtype=jnp.float32)
    v = jd.init(jax.random.PRNGKey(seed), jnp.zeros((1, 9, e)),
                jnp.zeros((1, 3), jnp.int32))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, v)
    v["params"]["fc"]["bias"][EOS] += eos_bias
    td = AttentiveDecoder(vocab, width, width, width, e, dtype=torch.float32)
    td.load_state_dict(tw.from_flax_decoder(v))
    return jd, v, td


@pytest.mark.parametrize("seed,b,eos_bias", [(0, 5, 0.5), (1, 3, 1.0),
                                             (2, 7, 1.0), (3, 7, 0.5),
                                             (3, 1, 0.5)])
def test_greedy_tokens_match_jax_and_interpret_kernel(seed, b, eos_bias):
    """float32: identical tokens to JAX greedy_decode and to the Pallas K1
    in interpret mode, for a ragged batch (not a multiple of the kernel's
    row block) with rows retiring at different steps."""
    jd, v, td = _tiny(seed, eos_bias)
    enc = np.random.default_rng(seed).normal(size=(b, 9, 16)).astype(
        np.float32)
    want = np.asarray(j_greedy(jd, v, jnp.asarray(enc), 40))
    kern = np.asarray(j_fused(jd, v, jnp.asarray(enc), 40, block_b=8,
                              interpret=True))
    got = greedy_decode(td, torch.from_numpy(enc), 40).numpy()
    assert got.dtype == np.int32 and got.shape == (b, 40)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kern)
    fused = fd.fused_greedy_decode(td, torch.from_numpy(enc), 40).numpy()
    np.testing.assert_array_equal(fused, want)


def test_eos_retirement_semantics():
    """A row writes its tokens up to and including EOS, then PAD; rows that
    never emit EOS run to max_length."""
    _, _, td = _tiny(3, 0.5)
    enc = torch.from_numpy(np.random.default_rng(3).normal(
        size=(7, 9, 16)).astype(np.float32))
    preds = greedy_decode(td, enc, 40).numpy()
    retired = 0
    for row in preds:
        hits = np.flatnonzero(row == EOS)
        if hits.size:
            retired += 1
            assert (row[hits[0] + 1:] == PAD).all()
    assert 0 < retired < len(preds)


def test_shipped_decoder_matches_jax_float32():
    """The shipped decoder weights at full width (E = A = H = D = 512,
    V = 451), run in float32: identical tokens to JAX greedy_decode."""
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    jd = JDecoder(vocab_size=451, embed_dim=512, attention_dim=512,
                  decoder_dim=512, encoder_dim=512, dtype=jnp.float32)
    td = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.float32)
    td.load_state_dict(tw.from_flax_decoder(tree))
    rng = np.random.default_rng(0)
    enc = np.maximum(rng.normal(1.0, 1.5, size=(2, 196, 512)), 0).astype(
        np.float32)
    want = np.asarray(j_greedy(jd, tree, jnp.asarray(enc), 24))
    got = greedy_decode(td, torch.from_numpy(enc), 24).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_plain_version_on_cpu_only():
    _, _, td = _tiny(0, 0.0)
    enc = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 9, 16)).astype(np.float32))
    before = fd.launch_count
    fd.fused_greedy_decode(td, enc, 12)
    assert fd.launch_count == before  # the plain version is no launch
    meta = enc.to("meta")
    with pytest.raises(ValueError, match="no fused decode"):
        fd.fused_greedy_decode_packed(meta, meta, meta[:, 0], meta[:, 0],
                                      td.weights(torch.float32), 12)


def test_plain_version_reports_logit_gaps():
    _, _, td = _tiny(1, 1.5)
    enc = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 9, 16)).astype(np.float32))
    ep = td.project_encoding(enc)
    h, c = td.init_state(enc)
    preds, gaps = fd.fused_greedy_decode_plain(enc, ep, h, c,
                                               td.weights(torch.float32), 20,
                                               return_gaps=True)
    np.testing.assert_array_equal(preds.numpy(),
                                  greedy_decode(td, enc, 20).numpy())
    decoded = gaps.numpy() < np.inf
    assert decoded[:, 0].all() and (gaps.numpy()[decoded] >= 0).all()


def test_kernel_argument_checks():
    _, _, td = _tiny(0, 0.0)
    enc = torch.zeros(2, 9, 16)
    ep, (h, c) = td.project_encoding(enc), td.init_state(enc)
    w = td.weights(torch.float32)
    fd._check(enc, ep, h, c, w)  # consistent inputs pass
    with pytest.raises(TypeError):
        fd._check(enc.double(), ep, h, c, w)
    with pytest.raises(TypeError):
        fd._check(enc, ep, h, c, dict(w, wfc=w["wfc"].bfloat16()))
    with pytest.raises(ValueError):
        fd._check(enc, ep[:, :5], h, c, w)
    with pytest.raises(ValueError):
        fd._check(enc, ep, h.t(), c, w)


def test_build_lock_times_out(tmp_path):
    """A held build lock makes a second builder raise, not wait forever."""
    path = tmp_path / "k.lock"
    fd_held = os.open(path, os.O_RDWR | os.O_CREAT)
    try:
        fcntl.flock(fd_held, fcntl.LOCK_EX)
        with pytest.raises(TimeoutError):
            with build._file_lock(path, timeout=0.3):
                pass
    finally:
        os.close(fd_held)
    with build._file_lock(path, timeout=0.3):  # released: taken at once
        pass


# Host side of the step engine (csrc/decode_step.cuh) that K1 and K2 share.
# (E, A, H, D, V): the shipped widths and a small one.
WIDTHS = [(512, 512, 512, 512, 451), (16, 12, 20, 8, 51)]


def _plan_columns(plan, n_blocks, e, a, hdim, v):
    """Per block, the columns of each matrix it owns, read from the plan
    the way the kernel reads it (phase_head, phase_lstm)."""
    hs, us = plan["head_start"], plan["unit_start"]
    owned = []
    for b in range(n_blocks):
        head = np.arange(hs[b], hs[b + 1])
        units = np.arange(us[b], us[b + 1])
        owned.append({
            "watt": head[head < a], "wf": head[(head >= a) & (head < a + e)]
            - a, "wfc": head[head >= a + e] - a - e,
            "lstm": (units[:, None] + hdim * np.arange(4)).ravel()})
    return owned


@pytest.mark.parametrize("n_blocks", [1, 7, 132])
@pytest.mark.parametrize("e,a,hdim,d,v", WIDTHS)
def test_step_plan_covers_every_column_once(n_blocks, e, a, hdim, d, v):
    plan = fd.step_plan(n_blocks, a, e, v, hdim)
    assert {k: t.dtype for k, t in plan.items()} == {
        "head_start": np.int32, "unit_start": np.int32}
    assert all(t.shape == (n_blocks + 1,) for t in plan.values())
    assert all((np.diff(t) >= 0).all() for t in plan.values())
    owned = _plan_columns(plan, n_blocks, e, a, hdim, v)
    for name, n in (("watt", a), ("wf", e), ("wfc", v), ("lstm", 4 * hdim)):
        cols = np.concatenate([o[name] for o in owned])
        assert np.array_equal(np.sort(cols), np.arange(n)), name
    # Contiguous and even: block sizes differ by at most one.
    for t, n in ((plan["head_start"], a + e + v), (plan["unit_start"], hdim)):
        assert t[0] == 0 and t[-1] == n
        assert np.ptp(np.diff(t)) <= 1


@pytest.mark.parametrize("n_blocks", [1, 7, 132])
@pytest.mark.parametrize("e,a,hdim,d,v", WIDTHS)
def test_step_plan_keeps_a_units_gates_together(n_blocks, e, a, hdim, d, v):
    """The block that owns gate column j of unit j owns its f, g and o
    columns H + j, 2H + j and 3H + j too, so it updates the cell alone."""
    owner = np.full(4 * hdim, -1)
    for b, o in enumerate(_plan_columns(fd.step_plan(n_blocks, a, e, v, hdim),
                                        n_blocks, e, a, hdim, v)):
        owner[o["lstm"]] = b
    by_gate = owner.reshape(4, hdim)
    assert (by_gate >= 0).all() and (by_gate == by_gate[0]).all()


def _unpack(packed, e, a, hdim, d):
    """Invert pack_step_weights: the column-major layout back to (in, out)."""
    x = d + e
    xp = (x + 7) // 8 * 8
    m3 = packed["m3"]  # (4H, Xp + Hp), row 4j + g
    gate_major = lambda m: m.view(hdim, 4, -1).transpose(0, 1).reshape(
        4 * hdim, -1)
    return {"watt": packed["m1"][:a, :hdim].t(),
            "wf": packed["m1"][a:, :hdim].t(),
            "wx": gate_major(m3[:, :x]).t(),
            "wh": gate_major(m3[:, xp:xp + hdim]).t(),
            "wfc": packed["fc"][:, :hdim].t()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,a,hdim,d,v", WIDTHS)
def test_pack_step_weights_round_trips(dtype, e, a, hdim, d, v):
    """pack_step_weights keeps every weight bit for bit, pads with zeros to
    multiples of 8 (16-byte loads), and the head stays float32."""
    dt = getattr(torch, dtype)
    if (e, a, hdim, d, v) == WIDTHS[0]:
        tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
        td = AttentiveDecoder(v, d, a, hdim, e)
        td.load_state_dict(tw.from_flax_decoder(tree))
    else:
        td = AttentiveDecoder(v, d, a, hdim, e)
        gen = torch.Generator().manual_seed(0)
        for prm in td.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen))
    w = td.weights(dt)
    packed = fd.pack_step_weights(w)
    hp, xp = (hdim + 7) // 8 * 8, (d + e + 7) // 8 * 8
    assert packed["m1"].shape == (a + e, hp) and packed["m1"].dtype == dt
    assert packed["m3"].shape == (4 * hdim, xp + hp)
    assert packed["fc"].shape == (v, hp) and packed["fc"].dtype == torch.float32
    assert all(t.is_contiguous() for t in packed.values())
    for name, t in _unpack(packed, e, a, hdim, d).items():
        assert t.dtype == w[name].dtype and torch.equal(t, w[name]), name
    for k in ("batt", "v", "bv", "bf", "blstm", "emb", "bfc"):
        assert packed[k] is w[k]
    # The padding is zero, so the kernel may sum over it.
    assert not packed["m1"][:, hdim:].any() and not packed["fc"][:, hdim:].any()
    assert not packed["m3"][:, d + e:xp].any()
    assert not packed["m3"][:, xp + hdim:].any()


def test_step_weights_packed_once_per_model():
    _, _, td = _tiny(0, 0.0)
    first = fd.step_weights(td, torch.float32)
    assert fd.step_weights(td, torch.float32) is first
    assert fd.step_weights(td, torch.bfloat16)["m1"].dtype == torch.bfloat16
    with torch.no_grad():
        td.wx.add_(1.0)  # a changed parameter is packed anew
    again = fd.step_weights(td, torch.float32)
    assert again is not first
    assert torch.equal(_unpack(again, 16, 16, 16, 16)["wx"],
                       td.weights(torch.float32)["wx"])


def test_pointer_and_dim_order_match_the_engine_header():
    """STEP_POINTERS and STEP_DIMS list the C arrays in the order of
    ``enum Ptr`` and ``enum Dim`` in csrc/decode_step.cuh."""
    import re
    text = (REPO / "stroke_derenderer_tpu_torch" / "csrc"
            / "decode_step.cuh").read_text()
    for enum, prefix, names, end in (("Ptr", "P_", fd.STEP_POINTERS, "N_PTR"),
                                     ("Dim", "D_", fd.STEP_DIMS, "N_DIM")):
        body = re.search(r"enum %s \{(.*?)\};" % enum, text, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        idents = re.findall(r"\b[A-Z_0-9]+\b", body)
        assert idents[-1] == end
        want = [prefix + n.upper() for n in names]
        assert idents[:-1] == want


class _FakeEntry:
    """Records the arrays a launch hands to the C entry point."""

    def __init__(self):
        self.calls = []

    def __call__(self, dtype, ptrs, dims, grid, stream):
        import ctypes
        self.calls.append((dtype, ctypes.cast(
            ptrs, ctypes.POINTER(ctypes.c_void_p * len(fd.STEP_POINTERS)))
            .contents[:], ctypes.cast(dims, ctypes.POINTER(
                ctypes.c_int * len(fd.STEP_DIMS))).contents[:], grid))
        return 0


def fake_launch(monkeypatch, grid):
    """Route launch_step_kernel to a recording entry point on the CPU."""
    entry = _FakeEntry()
    monkeypatch.setattr(fd, "_library", lambda name="fused_decode": (
        None, entry, None))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type(
        "S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(fd, "launch_grid", lambda name, dt, dims, dev: (
        grid, {k: torch.from_numpy(t) for k, t in fd.step_plan(
            grid, dims["A"], dims["E"], dims["V"], dims["H"]).items()}))
    return entry


def test_launch_hands_the_engine_its_arrays(monkeypatch):
    """K1's launch on the host side: the dims in STEP_DIMS order, every
    pointer the greedy kernel reads set, the beam-only ones and the phase
    clock (off) null."""
    entry = fake_launch(monkeypatch, 7)
    _, _, td = _tiny(0, 0.0)
    enc = torch.zeros(3, 9, 16)
    ep, (h, c) = td.project_encoding(enc), td.init_state(enc)
    preds = torch.full((3, 12), PAD, dtype=torch.int32)
    fd.launch_step_kernel("fused_decode", enc, ep, h, c,
                          fd.pack_step_weights(td.weights(torch.float32)), 1,
                          12, {"preds": preds})
    dtype, ptrs, dims, grid = entry.calls[0]
    assert (dtype, grid) == (0, 7)
    # float32 streams: the float64 path, no tensor-core plan.
    assert dims == [3, 9, 16, 16, 16, 16, 51, 1, 12, 0, 0, 0, 0]
    got = dict(zip(fd.STEP_POINTERS, ptrs))
    assert got["enc"] == enc.data_ptr() and got["preds"] == preds.data_ptr()
    beam_only = {"tok", "parent", "score", "fin", "len", "done", "steps",
                 "bp_parent", "bp_write", "score_out", "lens_out"}
    assert {n for n, v in got.items() if v is None} == beam_only | {
        "stamps", *fd.MMA_ONLY}

"""K3 and the fused-attention greedy entry: the plain version of the fused
attention + gate against the JAX reference and the Pallas kernel run in
interpret mode, ``step_with_awe`` against flax, ``greedy_decode(fused=True)``
against the JAX entry of the same name, and the dispatcher's routing and
argument checks. The CUDA kernel itself is tested on a card by
``test_torch_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu.kernels.decode_attention import (
    fused_attention_gate as j_fused_attention,
)
from stroke_derenderer_tpu.kernels.decode_attention import (
    fused_attention_gate_reference as j_reference,
)
from stroke_derenderer_tpu.models import AttentiveDecoder as JDecoder
from stroke_derenderer_tpu.models import greedy_decode as j_greedy
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import EOS
from stroke_derenderer_tpu_torch.kernels import decode_attention as da
from stroke_derenderer_tpu_torch.models.decoder import (
    AttentiveDecoder, attend, decode_step, greedy_decode, step_with_awe,
)


def _inputs(seed, b, p, e=24, a=20, d=12):
    """enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    return [f(b, p, e), f(b, p, a), f(b, d), f(d, a, s=0.3), f(a), f(a),
            f(1), f(d, e, s=0.3), f(e)]


def _jax_args(args):
    """The JAX entry takes b_v as a scalar."""
    j = [jnp.asarray(x) for x in args]
    j[6] = j[6][0]
    return j


@pytest.mark.parametrize("seed,b,p", [(0, 1, 9), (1, 3, 13), (2, 5, 196)])
def test_plain_matches_jax_reference(seed, b, p):
    """stream_dtype=None: the JAX reference's math in float32, odd B and P;
    each row of alpha sums to 1."""
    args = _inputs(seed, b, p)
    want = j_reference(*_jax_args(args))
    got = da.fused_attention_gate_plain(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(got[1].sum(1).numpy(), np.ones(b), atol=1e-6)


@pytest.mark.parametrize("seed,b,p", [(3, 1, 9), (4, 5, 13), (5, 7, 131)])
def test_plain_bf16_streams_match_interpret_kernel(seed, b, p):
    """stream_dtype=bfloat16 is the TPU kernel's function: bfloat16 inputs,
    float32 arithmetic, b_v dropped (it cancels in the softmax)."""
    args = _inputs(seed, b, p)
    want = j_fused_attention(*_jax_args(args), interpret=True)
    got = da.fused_attention_gate_plain(*map(torch.from_numpy, args),
                                        stream_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(got[1].sum(1).numpy(), np.ones(b), atol=1e-6)


def _tiny(seed, eos_bias, dtype="float32", width=16, vocab=51, e=16):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jd = JDecoder(vocab_size=vocab, embed_dim=width, attention_dim=width,
                  decoder_dim=width, encoder_dim=e, dtype=jdt)
    v = jd.init(jax.random.PRNGKey(seed), jnp.zeros((1, 9, e)),
                jnp.zeros((1, 3), jnp.int32))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3.0, v)
    v["params"]["fc"]["bias"][EOS] += eos_bias
    td = AttentiveDecoder(vocab, width, width, width, e, dtype=tdt)
    td.load_state_dict(tw.from_flax_decoder(v))
    return jd, v, td


@pytest.mark.parametrize("seed,b,eos_bias", [(0, 5, 0.5), (1, 3, 1.0),
                                             (2, 7, 1.0), (3, 1, 0.5)])
def test_fused_greedy_matches_jax_float32(seed, b, eos_bias):
    """greedy_decode(fused=True) against the JAX entry of the same name in
    float32: identical tokens, and the same tokens as the unfused entry."""
    jd, v, td = _tiny(seed, eos_bias)
    enc = np.random.default_rng(seed).normal(size=(b, 9, 16)).astype(
        np.float32)
    want = np.asarray(j_greedy(jd, v, jnp.asarray(enc), 40, fused=True))
    before = da.launch_count
    got = greedy_decode(td, torch.from_numpy(enc), 40, fused=True).numpy()
    assert da.launch_count == before  # the CPU runs the plain version
    assert got.dtype == np.int32 and got.shape == (b, 40)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, greedy_decode(td, torch.from_numpy(enc), 40).numpy())


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 3e-2)])
def test_step_with_awe_matches_flax(dtype, atol):
    """The LSTM + head half against flax's step_with_awe on the same
    inputs (float32: the sums run in other orders; bfloat16: h and c are
    rounded to 8 bits of mantissa, one ulp of 2.3 is 0.016); decode_step is
    attend followed by step_with_awe, bit for bit."""
    jd, v, td = _tiny(4, 0.0, dtype)
    tdt = td.dtype
    rng = np.random.default_rng(4)
    emb, awe, h, c = (rng.normal(size=(3, 16)).astype(np.float32)
                      for _ in range(4))
    jl, jh, jc = jd.apply(v, *(jnp.asarray(x).astype(jd.dtype)
                               for x in (emb, awe, h, c)),
                          method=JDecoder.step_with_awe)
    t = [torch.from_numpy(x).to(tdt) for x in (emb, awe, h, c)]
    w = td.weights()
    tl, th, tc = step_with_awe(w, *t)
    assert tl.dtype == torch.float32 and th.dtype == tdt
    for got, want in ((tl, jl), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=0, atol=atol)
    enc = torch.from_numpy(rng.normal(size=(3, 9, 16)).astype(np.float32))
    enc = enc.to(tdt)
    ep = td.project_encoding(enc)
    whole = decode_step(w, enc, ep, t[0], t[2], t[3])
    halves = step_with_awe(w, t[0], attend(w, enc, ep, t[2]), t[2], t[3])
    for x, y in zip(whole, halves):
        assert torch.equal(x, y)


def test_dispatcher_routes_cpu_only_and_checks():
    args = [torch.from_numpy(x) for x in _inputs(6, 2, 9)]
    before = da.launch_count
    out, alpha = da.fused_attention_gate(*args)
    assert da.launch_count == before
    want = da.fused_attention_gate_plain(*args)
    assert torch.equal(out, want[0]) and torch.equal(alpha, want[1])
    with pytest.raises(ValueError, match="no fused attention"):
        da.fused_attention_gate(*(x.to("meta") for x in args))
    da._check(*args)  # consistent inputs pass
    for i, bad in [(1, args[1][:, :4]), (2, args[2].t()),
                   (3, args[3][:, :5]), (6, torch.zeros(2)),
                   (7, args[7].t())]:
        with pytest.raises(ValueError):
            da._check(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="no encoder positions"):
        da._check(args[0][:, :0], args[1][:, :0], *args[2:])

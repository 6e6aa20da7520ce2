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


# --- the cluster design's host side: plan, packed weights, split softmax ---

@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("a,e", [(512, 512), (24, 16)])
def test_attention_plan_covers_everything_once(cluster, a, e):
    """Every row, [W_att | W_f] column, position and output column belongs
    to exactly one cluster or CTA, in contiguous ranges, within the sizes
    the kernel lays its shared memory out for."""
    for p in (1, 13, 196):
        for b in (0, 1, 4, 13, 80):
            for clusters in (None, 7):
                plan = da.attention_plan(b, p, a, e, cluster, clusters)
                g = min(b, clusters or 132 // cluster)
                assert all(t.dtype == np.int32 for t in plan.values())
                for key, total, n, most in (
                        ("rows", b, g, -(-b // max(g, 1))),
                        ("columns", a + e, cluster, a + e),
                        ("positions", p, cluster, -(-p // cluster)),
                        ("outputs", e, cluster,
                         4 * -(-(e // 4) // cluster))):
                    starts = plan[key]
                    assert len(starts) == n + 1, key
                    owned = np.concatenate(
                        [np.arange(starts[i], starts[i + 1])
                         for i in range(n)] or [np.zeros(0, int)])
                    np.testing.assert_array_equal(owned, np.arange(total))
                    assert np.diff(starts).max(initial=0) <= most, key
                assert not (plan["columns"][:-1] % 8).any()
                assert not (plan["outputs"][:-1] % 4).any()


def test_attention_plan_rejects_cluster_sizes():
    for bad in (0, 17):
        with pytest.raises(ValueError, match="cluster size"):
            da.attention_plan(4, 196, 512, 512, bad)


def test_pack_attention_weights_round_trips_and_is_cached():
    """m1's rows are the columns of W_att, then W_f, bit for bit in
    bfloat16, zero-padded to a multiple of 8; each row 16-byte aligned; the
    decoder's pack is made once and remade when a weight changes."""
    d, a, e = 12, 24, 16
    args = [torch.from_numpy(x) for x in _inputs(7, 1, 1, e, a, d)]
    w_att, b_att, v, _, w_f, b_f = args[3:]
    packed = da.pack_attention_weights(w_att, b_att, v, w_f, b_f)
    m1 = packed["m1"]
    assert m1.dtype == torch.bfloat16 and m1.shape == (a + e, 16)
    assert m1.is_contiguous() and m1.stride(0) * 2 % 16 == 0
    bits = lambda t: t.contiguous().view(torch.int16)
    assert torch.equal(bits(m1[:a, :d].t()), bits(w_att.to(torch.bfloat16)))
    assert torch.equal(bits(m1[a:, :d].t()), bits(w_f.to(torch.bfloat16)))
    assert not m1[:, d:].float().any()
    assert torch.equal(bits(packed["bias"]),
                       bits(torch.cat([b_att, b_f]).to(torch.bfloat16)))
    assert torch.equal(bits(packed["v"]), bits(v.to(torch.bfloat16)))
    td = _tiny(0, 0.0)[2]
    first = da.attention_weights(td)
    assert da.attention_weights(td) is first
    with torch.no_grad():
        td.watt.add_(1.0)
    again = da.attention_weights(td)
    assert again is not first
    assert torch.equal(again["m1"][:16, :16].t(), td.watt.to(torch.bfloat16))


def _packed(args):
    return da.pack_attention_weights(args[3], args[4], args[5], args[7],
                                     args[8])


@pytest.mark.parametrize("seed,b,p,cluster,clusters", [
    (0, 1, 1, 16, None), (1, 3, 13, 16, None), (2, 5, 196, 8, None),
    (3, 7, 9, 1, None), (4, 9, 13, 8, 4), (5, 2, 5, 16, 1)])
def test_split_softmax_matches_plain_bf16(seed, b, p, cluster, clusters):
    """The kernel's order of work (per-CTA columns, local softmaxes over
    position slices, rescaled by exp(m_c - m) and combined) against the
    plain version with bfloat16 streams, at odd B and P, CTAs without
    positions included: within 1e-5 + 1e-4 relative (both sum in float32,
    in other orders)."""
    args = [torch.from_numpy(x) for x in _inputs(seed, b, p, e=24, a=16)]
    got = da.fused_attention_gate_split(*args[:3], _packed(args), cluster,
                                        clusters)
    want = da.fused_attention_gate_plain(*args, stream_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed,b,p,cluster", [(3, 1, 9, 16), (4, 5, 13, 8),
                                              (5, 7, 131, 16)])
def test_split_softmax_matches_interpret_kernel(seed, b, p, cluster):
    """The same against the TPU kernel run in interpret mode, with the
    tolerance of the plain version's test."""
    args = _inputs(seed, b, p, e=24, a=16)
    want = j_fused_attention(*_jax_args(args), interpret=True)
    t = [torch.from_numpy(x) for x in args]
    got = da.fused_attention_gate_split(*t[:3], _packed(t), cluster)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_widths_the_kernel_does_not_take_raise():
    da.check_widths(512, 512, 512)
    da.check_widths(16, 24, 12)  # D needs no multiple of 8
    for (e, a, d), name in (((20, 24, 12), "E=20"), ((16, 12, 12), "A=12"),
                            ((16, 24, 2000), "D=2000")):
        with pytest.raises(ValueError, match=name):
            da.check_widths(e, a, d)


def test_phase_clock_counts_points_not_passed_as_no_time():
    """K3's phase clock: cycles scaled by the global timer; a point CTA 0
    did not pass (zero) takes no time."""
    n = da.STAMPS.index("timer_entry")
    cycles = [1000 * i for i in range(n)]
    cycles[da.STAMPS.index("scores")] = 0
    us = da.phase_us(cycles + [5, 5 + 2 * cycles[-1]])  # 2 ns per cycle
    assert list(us) == list(da.STAMPS[1:n])
    assert us["scores"] == 0.0 and us["softmax"] == 4.0
    assert sum(us.values()) == 2 * cycles[-1] / 1e3

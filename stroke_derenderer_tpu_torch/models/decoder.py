"""Attentive LSTM stroke decoder, counterpart of the JAX ``models/decoder.py``.

One step: additive attention ``softmax(v . relu(enc_proj + h Watt + b))``
over the P encoder positions, a sigmoid gate ``sigmoid(h Wf + bf)`` on the
attended vector, an LSTM cell over ``[emb; awe]`` and a float32 vocabulary
head on h.

The parameters are kept in the layout that the fused decode kernel reads
(``kernels/fused_decode.py``): dense kernels as (in, out), the LSTM's four
input kernels packed into ``wx`` (D+E, 4H) and its four hidden kernels into
``wh`` (H, 4H) in i, f, g, o order, with the hidden side's summed bias in
``blstm``.

Rounding follows flax in the compute dtype (bfloat16 as shipped): a Dense
rounds its product to the compute dtype and then adds its bias, rounding
again; sigmoid and tanh take float32 in and round the result; elementwise
products and sums round after each operation; the vocabulary head is
float32. Products, the attention softmax and the attended sum are taken in
float64 before their one rounding (:func:`dense`): flax sums in float32, in
an order of its own, and so does any kernel, so a one-ulp difference in a
bfloat16 rounding could appear anywhere and, fed back through the greedy
loop, change later tokens. Summed in float64, the rounded result no longer
depends on the order, so the fused kernel and this step agree bit for bit.

Training takes :meth:`AttentiveDecoder.forward`, the teacher-forced pass of
the JAX ``__call__``: the same step with plain products in the compute
dtype (float32 accumulation, as flax's), each weight cast once per
forward. The parameters are registered without gradients, so that the
inference entries build no autograd graph; the trainer turns them on.
"""

from __future__ import annotations

import torch
from torch import nn

from stroke_derenderer_tpu_torch.config import BOS, EOS, PAD
from stroke_derenderer_tpu_torch.parallel.mesh import column_parallel

# Weights the kernel and the step read; the vocabulary head stays float32.
STEP_WEIGHTS = ("watt", "batt", "v", "bv", "wf", "bf", "wx", "wh", "blstm",
                "emb", "wfc", "bfc")
F32_WEIGHTS = ("wfc", "bfc")
# The attention half's weights, in the argument order of
# ``kernels.decode_attention.fused_attention_gate``.
ATTENTION_WEIGHTS = ("watt", "batt", "v", "bv", "wf", "bf")


def dense(x, w, b=None):
    """``x @ w`` summed in float64 and rounded once to x's dtype, then the
    bias added in x's dtype (a flax Dense)."""
    y = (x.double() @ w.double()).to(x.dtype)
    return y if b is None else y + b


def attend(w: dict, enc, enc_proj, h):
    """The attention half of a step: the gated attended vector
    ``sigmoid(h Wf + bf) * sum_p alpha_p enc_p`` (B, E) in h's dtype."""
    att = torch.relu(enc_proj + dense(h, w["watt"], w["batt"])[:, None, :])
    alpha = torch.softmax(dense(att, w["v"], w["bv"]).double(), dim=1)
    awe = torch.bmm(alpha[:, None, :], enc.double())[:, 0]
    gate = torch.sigmoid(dense(h, w["wf"], w["bf"]))
    return (gate.double() * awe).to(h.dtype)


def step_with_awe(w: dict, emb, awe, h, c):
    """The LSTM and the vocabulary head once the attended vector is known
    (counterpart of the JAX ``AttentiveDecoder.step_with_awe``). ``awe`` is
    rounded to h's dtype first. Returns (logits float32 (B, V), h, c)."""
    hdim = h.shape[-1]
    x = torch.cat([emb, awe.to(h.dtype)], dim=-1)
    gates = dense(x, w["wx"]) + dense(h, w["wh"], w["blstm"])
    i = torch.sigmoid(gates[:, :hdim])
    f = torch.sigmoid(gates[:, hdim:2 * hdim])
    g = torch.tanh(gates[:, 2 * hdim:3 * hdim])
    o = torch.sigmoid(gates[:, 3 * hdim:])
    c = f * c + i * g
    h = o * torch.tanh(c)
    return dense(h.float(), w["wfc"], w["bfc"]), h, c


def decode_step(w: dict, enc, enc_proj, emb, h, c):
    """One decode step on the weights of :meth:`AttentiveDecoder.weights`.
    enc, enc_proj: (B, P, E|A); emb, h, c: (B, D|H) in the compute dtype.
    Returns (logits float32 (B, V), h, c)."""
    return step_with_awe(w, emb, attend(w, enc, enc_proj, h), h, c)


class AttentiveDecoder(nn.Module):
    def __init__(self, vocab_size: int = 451, embed_dim: int = 512,
                 attention_dim: int = 512, decoder_dim: int = 512,
                 encoder_dim: int = 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        v, d, a, h, e = (vocab_size, embed_dim, attention_dim, decoder_dim,
                         encoder_dim)
        self.dtype = dtype
        shapes = {
            "emb": (v, d), "enc_att_w": (e, a), "enc_att_b": (a,),
            "watt": (h, a), "batt": (a,), "v": (a,), "bv": (1,),
            "init_h_w": (e, h), "init_h_b": (h,),
            "init_c_w": (e, h), "init_c_b": (h,),
            "wf": (h, e), "bf": (e,),
            "wx": (d + e, 4 * h), "wh": (h, 4 * h), "blstm": (4 * h,),
            "wfc": (h, v), "bfc": (v,),
        }
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))

    def forget_packed(self) -> None:
        """Drop the kernels' packed copies of the weights (K1's
        ``step_weights``, K3's ``attention_weights``). Their caches key on
        each parameter's storage and version counter, which a fused
        optimizer step does not bump, so the trainer calls this after every
        update."""
        self.__dict__.pop("_step_weights", None)
        self.__dict__.pop("_attention_weights", None)

    def forward(self, enc_seq, tokens):
        """Teacher-forced training forward: (B, P, E) encoder sequence (any
        float dtype, float32 from the encoder), (B, T) int tokens -> (B, T,
        V) float32 logits, one step per token as the JAX ``__call__`` scans
        it. Rounding as flax in the compute dtype: each Dense's product and
        bias add; the attention softmax and the attended sum over the
        encoder sequence as given in float32; the head in float32."""
        dt = self.dtype
        w = {k: getattr(self, k).to(dt) for k in (
            "enc_att_w", "enc_att_b", "init_h_w", "init_h_b", "init_c_w",
            "init_c_b", "watt", "batt", "v", "bv", "wf", "bf", "wx", "wh",
            "blstm", "emb")}
        enc_f32 = enc_seq.float()
        tp = getattr(self, "tp_mesh", None)  # enc_att_w column-parallel
        enc_proj = (enc_seq.to(dt) @ w["enc_att_w"] if tp is None else
                    column_parallel(lambda x: x @ w["enc_att_w"],
                                    enc_seq.to(dt), tp, -1)) + w["enc_att_b"]
        mean = enc_f32.mean(dim=1).to(enc_seq.dtype).to(dt)
        h = mean @ w["init_h_w"] + w["init_h_b"]
        c = mean @ w["init_c_w"] + w["init_c_b"]
        embs = w["emb"][tokens]
        v = w["v"][:, None]
        hdim = h.shape[-1]
        logits = []
        for t in range(tokens.shape[1]):
            att = torch.relu(enc_proj + (h @ w["watt"] + w["batt"])[:, None])
            alpha = torch.softmax((att @ v + w["bv"]).float(), dim=1)
            awe = torch.bmm(alpha.transpose(1, 2), enc_f32)[:, 0]
            gate = torch.sigmoid(h @ w["wf"] + w["bf"])
            x = torch.cat([embs[:, t], (gate.float() * awe).to(dt)], dim=-1)
            gates = x @ w["wx"] + (h @ w["wh"] + w["blstm"])
            i = torch.sigmoid(gates[:, :hdim])
            f = torch.sigmoid(gates[:, hdim:2 * hdim])
            g = torch.tanh(gates[:, 2 * hdim:3 * hdim])
            o = torch.sigmoid(gates[:, 3 * hdim:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            logits.append(h.float() @ self.wfc + self.bfc)
        return torch.stack(logits, dim=1)

    def weights(self, dtype: torch.dtype | None = None) -> dict:
        """The step's weights cast to ``dtype`` (the vocabulary head stays
        float32), as contiguous tensors."""
        dtype = dtype or self.dtype
        return {k: getattr(self, k).to(torch.float32 if k in F32_WEIGHTS
                                       else dtype).contiguous()
                for k in STEP_WEIGHTS}

    def project_encoding(self, enc_seq):
        """(B, P, E) -> (B, P, A), once before the loop."""
        dt = enc_seq.dtype
        return dense(enc_seq, self.enc_att_w.to(dt), self.enc_att_b.to(dt))

    def init_state(self, enc_seq):
        """Initial (h, c) from the mean-pooled encoding (the mean is taken in
        float32, as jnp.mean does for bfloat16)."""
        dt = enc_seq.dtype
        mean = enc_seq.float().mean(dim=1).to(dt)
        return (dense(mean, self.init_h_w.to(dt), self.init_h_b.to(dt)),
                dense(mean, self.init_c_w.to(dt), self.init_c_b.to(dt)))

    def embed(self, tokens, dtype: torch.dtype | None = None):
        return self.emb.to(dtype or self.dtype)[tokens]

    def step(self, enc_seq, enc_proj, emb, h, c):
        """One decode step -> (logits float32, h, c)."""
        return decode_step(self.weights(enc_seq.dtype), enc_seq, enc_proj,
                           emb, h, c)


def greedy_loop(step, emb_table, h, c, max_length: int,
                return_gaps: bool = False):
    """The greedy loop around ``step(emb, h, c) -> (logits, h, c)``: start
    from BOS; every active row writes its argmax, the EOS that ends it
    included, and PAD after that; retired rows freeze h, c and emb; the loop
    stops once every row has retired. Returns (B, max_length) int32 tokens;
    with ``return_gaps`` also the (B, max_length) float32 gap between the two
    largest logits at each step (inf where not decoded)."""
    b = h.shape[0]
    dev = h.device
    preds = torch.full((b, max_length), PAD, dtype=torch.int32, device=dev)
    gaps = torch.full((b, max_length), float("inf"), device=dev)
    emb = emb_table[torch.full((b,), BOS, dtype=torch.long, device=dev)]
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for t in range(max_length):
        if not bool(active.any()):
            break
        logits, h2, c2 = step(emb, h, c)
        tok = logits.argmax(dim=-1)
        if return_gaps:
            top2 = logits.topk(2, dim=-1).values
            gaps[:, t] = torch.where(active, top2[:, 0] - top2[:, 1],
                                     float("inf"))
        preds[:, t] = torch.where(active, tok, PAD).to(torch.int32)
        keep = active[:, None]
        h = torch.where(keep, h2, h)
        c = torch.where(keep, c2, c)
        emb = torch.where(keep, emb_table[tok], emb)
        active = active & (tok != EOS)
    return (preds, gaps) if return_gaps else preds


def greedy_decode(decoder: AttentiveDecoder, enc_seq, max_length: int,
                  fused: bool = False, return_gaps: bool = False):
    """(B, P, E) encoder sequence -> (B, max_length) int32 tokens, stepping
    in Python (:func:`greedy_loop`).

    ``fused=True`` takes the attention and gate of each step from
    ``kernels.decode_attention.fused_attention_gate`` (the CUDA kernel K3 on
    the card, its plain version on the CPU), given the float32 parameters
    as the JAX entry gives them, and the LSTM and head from
    :func:`step_with_awe`. On the card the attention weights are packed once
    per decoder and the encoder sequence and its projection are cast to the
    kernel's bfloat16 streams once per decode, not at every step."""
    enc_proj = decoder.project_encoding(enc_seq)
    h, c = decoder.init_state(enc_seq)
    w = decoder.weights(enc_seq.dtype)
    if not fused:
        from stroke_derenderer_tpu_torch.kernels.fused_decode import (
            fused_greedy_decode_plain,
        )
        return fused_greedy_decode_plain(enc_seq, enc_proj, h, c, w,
                                         max_length, return_gaps)
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    att_w = [getattr(decoder, k) for k in ATTENTION_WEIGHTS]
    packed, enc_k, proj_k = None, enc_seq, enc_proj
    if enc_seq.is_cuda:
        packed = da.attention_weights(decoder)
        enc_k, proj_k = (t.to(torch.bfloat16).contiguous()
                         for t in (enc_seq, enc_proj))

    def step(emb, h, c):
        awe, _ = da.fused_attention_gate(enc_k, proj_k, h, *att_w,
                                         packed=packed)
        return step_with_awe(w, emb, awe, h, c)

    return greedy_loop(step, w["emb"], h, c, max_length, return_gaps)


def beam_decode(decoder: AttentiveDecoder, enc_seq, max_length: int,
                beam_size: int = 5, length_penalty: float = 0.0):
    """(B, P, E) encoder sequence -> (B, max_length) int32 tokens of the
    best of ``beam_size`` beams, stepping in Python (counterpart of the JAX
    ``beam_decode``). Only beam 0 is live at the start; finished beams
    extend only with PAD at a frozen score; ``length_penalty`` > 0 ranks the
    final beams by score / ((5 + len) / 6) ** length_penalty."""
    from stroke_derenderer_tpu_torch.kernels.fused_beam import (
        fused_beam_decode_plain, select_beam,
    )
    enc_proj = decoder.project_encoding(enc_seq)
    h, c = decoder.init_state(enc_seq)
    preds, score, lens = fused_beam_decode_plain(
        enc_seq, enc_proj, h, c, decoder.weights(enc_seq.dtype), max_length,
        beam_size)
    return select_beam(preds, score, lens, length_penalty)

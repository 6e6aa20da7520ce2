"""K2: the fused beam-search decode, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
fused_beam.py`` (``_kernel`` and ``_fused_beam_decode_tpu``), which runs
the whole beam search for one image in one program. The CUDA source is
``csrc/fused_beam.cu``, on the step engine ``csrc/decode_step.cuh`` that it
shares with K1 (host side in ``kernels/fused_decode.py``): one cooperative
launch per decode call runs the B x K beams of every image as rows of one
grid, every block owning a slice of every matrix's columns, with one more
grid barrier per step than K1 for the choice of the beams. All beam state
lives in global memory, so the kernel takes every K up to V.

Beside the kernel is its plain version, :func:`fused_beam_decode_plain`,
which steps the same search in Python with PyTorch ops. The wrapper
:func:`fused_beam_decode_packed` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``launch_count`` counts the kernel's launches, ``engine_launches`` the
same launches by path (``fused_decode.ENGINES``: bfloat16 streams on the
tensor cores, float32 on CUDA cores in float64). While a profile records,
each search adds ``fused_decode.decode_counts`` to
``utils.profiling.COUNTERS``, an image's beams counted until its last one
finished (its largest length).

Numerics follow K1 (``models/decoder.py``), and the search follows the TPU
kernel: the log-softmax is JAX's formula on the float32 logits (``x - max``,
then ``- log(sum exp)``, the sum of exponentials taken in float64);
``total = score + logp`` in float32 with ``NEG_INF = -1e30``, which absorbs
any log-probability added to it; top-K is K rounds of argmax and mask, ties
going to the lowest flat index over (K, V), as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import torch

from stroke_derenderer_tpu_torch.config import BOS, EOS, PAD
from stroke_derenderer_tpu_torch.kernels.fused_decode import (
    _MATRICES, ENGINES, _check, decode_counts, decode_sharded,
    launch_step_kernel, pack_step_weights, step_weights,
)
from stroke_derenderer_tpu_torch.models.decoder import decode_step
from stroke_derenderer_tpu_torch.utils.profiling import COUNTERS, recording

# Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0
# Launches by path since import (never reset by the wrappers' callers).
engine_launches = {"f64": 0, "mma": 0}

# Grid barriers per decode step.
BARRIERS_PER_STEP = 5

NEG_INF = -1e30


def log_softmax(logits):
    """JAX's ``log_softmax`` on float32 logits, the sum of exponentials
    taken in float64 and its log rounded once to float32."""
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    return shifted - shifted.double().exp().sum(-1, keepdim=True).log().float()


def top_k_lowest(flat, k: int):
    """The k largest values of each row of ``flat`` and their indices,
    largest first, ties to the lowest index: k rounds of argmax and mask
    with NEG_INF, as the TPU kernel does them."""
    flat = flat.clone()
    vals, idxs = [], []
    for _ in range(k):
        idx = flat.argmax(dim=1, keepdim=True)  # first maximal index
        vals.append(flat.gather(1, idx))
        idxs.append(idx)
        flat.scatter_(1, idx, NEG_INF)
    return torch.cat(vals, 1), torch.cat(idxs, 1)


def fused_beam_decode_plain(enc, enc_proj, h0, c0, w: dict, max_length: int,
                            k: int, return_gaps: bool = False):
    """The kernel's function in PyTorch ops, one Python iteration per step.

    enc (B, P, E), enc_proj (B, P, A), h0 and c0 (B, H) in the stream dtype;
    ``w`` from ``AttentiveDecoder.weights``. Returns every beam's tokens
    (B, k, max_length) int32, score (B, k) float32 (summed log-probability)
    and length (B, k) int32 (steps written before finishing, its EOS
    included): the raw outputs of the TPU kernel. With ``return_gaps`` also
    (B, max_length) float32: at each step the smallest gap between
    neighbours among the k + 1 best totals, which says how close the step
    came to another choice or order (inf where the image had finished)."""
    b = enc.shape[0]
    v = w["emb"].shape[0]
    if not 1 <= k <= v:
        raise ValueError(f"beam size must be at least 1 and at most the "
                         f"vocabulary ({v}), got {k}")
    dev = enc.device
    w = {n: (t.double() if n in _MATRICES else t) for n, t in w.items()}
    enc = enc.double().repeat_interleave(k, 0)
    enc_proj = enc_proj.repeat_interleave(k, 0)
    h, c = h0.repeat_interleave(k, 0), c0.repeat_interleave(k, 0)
    tok = torch.full((b * k,), BOS, dtype=torch.long, device=dev)
    # Only beam 0 is live at the start, so the first step picks k distinct
    # tokens from it.
    score = torch.full((b, k), NEG_INF, device=dev)
    score[:, 0] = 0.0
    fin = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    preds = torch.full((b, k, max_length), PAD, dtype=torch.int32,
                       device=dev)
    pad_only = torch.full((v,), NEG_INF, device=dev)
    pad_only[PAD] = 0.0
    first_row = torch.arange(b, device=dev)[:, None] * k
    gaps = torch.full((b, max_length), float("inf"), device=dev)
    for t in range(max_length):
        if bool(fin.all()):
            break
        logits, h2, c2 = decode_step(w, enc, enc_proj, w["emb"][tok], h, c)
        logp = log_softmax(logits).view(b, k, v)
        # Finished beams may only extend with PAD, at no cost.
        logp = torch.where(fin[..., None], pad_only, logp)
        total = score[..., None] + logp
        score, idx = top_k_lowest(total.view(b, k * v), k + return_gaps)
        if return_gaps:
            gap = (score[:, :-1] - score[:, 1:]).amin(dim=1)
            gaps[:, t] = torch.where(fin.all(dim=1), float("inf"), gap)
            score, idx = score[:, :k], idx[:, :k]
        parent, token = idx // v, idx % v
        src = (first_row + parent).view(-1)
        h, c = h2[src], c2[src]
        preds = preds.gather(1, parent[..., None].expand(-1, -1, max_length))
        fin_parent = fin.gather(1, parent)
        preds[:, :, t] = torch.where(fin_parent, PAD, token).to(torch.int32)
        lens = lens.gather(1, parent)
        lens = torch.where(fin_parent, lens, lens + 1)
        fin = fin_parent | (token == EOS)
        tok = token.view(-1)
    return (preds, score, lens, gaps) if return_gaps else (preds, score, lens)


def select_beam(preds, score, lens, length_penalty: float = 0.0):
    """(B, K, T) beams -> (B, T) tokens of the best one (the first on ties);
    ``length_penalty`` > 0 divides each score by ((5 + len) / 6) **
    length_penalty first (GNMT)."""
    if length_penalty > 0:
        score = score / ((5.0 + lens.float()) / 6.0) ** length_penalty
    best = score.argmax(dim=1)
    return preds[torch.arange(preds.shape[0], device=preds.device), best]


def _check_beam(enc, enc_proj, h0, c0, w: dict, k: int) -> None:
    _check(enc, enc_proj, h0, c0, w)
    if k < 1:
        raise ValueError(f"beam size must be at least 1, got {k}")
    if k > w["emb"].shape[0]:
        raise ValueError(f"beam size {k} exceeds the vocabulary "
                         f"({w['emb'].shape[0]})")


def beam_counts(lens: torch.Tensor, k: int, head: int, hdim: int,
                fixstat: torch.Tensor | None = None,
                astat: torch.Tensor | None = None) -> dict:
    """``fused_decode.decode_counts`` of one search from its beams' lengths
    (B, k), each image counted until its longest beam, on the host."""
    return decode_counts(lens.cpu().amax(1), k, head, hdim, fixstat, astat)


def fused_beam_decode_packed(enc, enc_proj, h0, c0, w: dict, max_length: int,
                             k: int, packed: dict | None = None):
    """(preds (B, k, max_length) int32, score (B, k) float32, lens (B, k)
    int32). CPU tensors run the plain version; CUDA tensors run the kernel,
    in one cooperative launch, on ``packed`` (``pack_step_weights`` of
    ``w``, packed here when not given)."""
    global launch_count
    head, hdim = enc_proj.shape[-1] + enc.shape[-1], h0.shape[-1]
    if enc.device.type == "cpu":
        preds, score, lens = fused_beam_decode_plain(enc, enc_proj, h0, c0,
                                                     w, max_length, k)
        if recording():
            COUNTERS.defer(beam_counts, lens, k, head, hdim)
        return preds, score, lens
    if enc.device.type != "cuda":
        raise ValueError(f"no fused beam decode for device {enc.device}")
    _check_beam(enc, enc_proj, h0, c0, w, k)
    b = enc.shape[0]
    dev = enc.device
    preds = torch.full((b, k, max_length), PAD, dtype=torch.int32, device=dev)
    score = torch.empty((b, k), dtype=torch.float32, device=dev)
    lens = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or max_length == 0:  # the state before the first step
        score.fill_(NEG_INF)[:, :1] = 0.0
        return preds, score, lens.fill_(0)
    launched = launch_step_kernel(
        "fused_beam", enc, enc_proj, h0, c0,
        pack_step_weights(w) if packed is None else packed, k, max_length,
        {"preds": preds, "score_out": score, "lens_out": lens})
    launch_count += 1
    engine_launches[ENGINES[enc.dtype]] += 1
    if recording():
        COUNTERS.defer(beam_counts, lens, k, head, hdim,
                       launched.get("fixstat"), launched["astat"])
    return preds, score, lens


def fused_beam_decode(decoder, enc_seq, max_length: int, beam_size: int = 5,
                      length_penalty: float = 0.0):
    """Counterpart of the JAX ``fused_beam_decode``: the attention
    projection and the initial state from the decoder, the fused search,
    then the length penalty and the choice of the best beam. Same
    (B, max_length) int32 output as ``models.decoder.beam_decode``."""
    enc_seq = enc_seq.contiguous()
    enc_proj = decoder.project_encoding(enc_seq).contiguous()
    h0, c0 = decoder.init_state(enc_seq)
    dt = enc_seq.dtype
    packed = step_weights(decoder, dt) if enc_seq.is_cuda else None
    preds, score, lens = fused_beam_decode_packed(
        enc_seq, enc_proj, h0.contiguous(), c0.contiguous(),
        decoder.weights(dt), max_length, beam_size, packed)
    return select_beam(preds, score, lens, length_penalty)


def fused_beam_decode_sharded(decoder, enc_seq, max_length: int, mesh,
                              batch: int | None = None, beam_size: int = 5,
                              length_penalty: float = 0.0):
    """:func:`fused_beam_decode` with the glyph batch sharded over the
    mesh's dp ranks (counterpart of the JAX ``fused_beam_decode_sharded``):
    ``fused_decode.decode_sharded``'s contract, one K2 launch per rank, the
    best beams' tokens of every rank gathered in global row order."""
    return decode_sharded(
        lambda rows: fused_beam_decode(decoder, rows, max_length, beam_size,
                                       length_penalty),
        enc_seq, max_length, mesh, batch)

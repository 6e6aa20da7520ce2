"""K2: the fused beam-search decode, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
fused_beam.py`` (``_kernel`` and ``_fused_beam_decode_tpu``), which runs
the whole beam search for one image in one program. The CUDA source is
``csrc/fused_beam.cu``; its header says what bounds it on an H100 and what
the design does about that. In short: one block per image owns its K
beams and runs the whole step loop; each block-step reads the weights once
for up to 8 beams and the image's encoder rows once for the same beams;
blocks never synchronise with each other.

Beside the kernel is its plain version, :func:`fused_beam_decode_plain`,
which steps the same search in Python with PyTorch ops. The wrapper
:func:`fused_beam_decode_packed` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``launch_count`` counts the kernel's launches.

Numerics follow K1 (``models/decoder.py``), and the search follows the TPU
kernel: the log-softmax is JAX's formula on the float32 logits (``x - max``,
then ``- log(sum exp)``, the sum of exponentials taken in float64);
``total = score + logp`` in float32 with ``NEG_INF = -1e30``, which absorbs
any log-probability added to it; top-K is K rounds of argmax and mask, ties
going to the lowest flat index over (K, V), as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import ctypes

import torch

from stroke_derenderer_tpu_torch.config import BOS, EOS, PAD
from stroke_derenderer_tpu_torch.kernels.fused_decode import (
    _DTYPE_CODE, _MATRICES, _check,
)
from stroke_derenderer_tpu_torch.models.decoder import (
    STEP_WEIGHTS, decode_step,
)

# Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0

NEG_INF = -1e30
# Largest beam the kernel takes: a thread holds one column of every beam's
# h and c in registers while it reorders them by parent.
MAX_BEAM = 16
# Shared memory a block may use on an H100 (227 KB), less room for the
# kernel's static shared memory.
_SMEM_LIMIT = 232448 - 2048


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
    if k < 1:
        raise ValueError(f"beam size must be at least 1, got {k}")
    b = enc.shape[0]
    v = w["emb"].shape[0]
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


def _library():
    from stroke_derenderer_tpu_torch.kernels.build import load_library
    lib = load_library("fused_beam")
    lib.sd_fused_beam_decode.restype = ctypes.c_int
    lib.sd_fused_beam_decode.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 21 + [ctypes.c_int] * 9
        + [ctypes.c_void_p])
    lib.sd_fused_beam_smem.restype = ctypes.c_size_t
    lib.sd_fused_beam_smem.argtypes = [ctypes.c_int] * 7
    return lib


def _check_beam(enc, enc_proj, h0, c0, w: dict, k: int) -> None:
    _check(enc, enc_proj, h0, c0, w)
    if not 1 <= k <= MAX_BEAM:
        raise ValueError(f"the fused beam decode takes beam sizes 1 to "
                         f"{MAX_BEAM}, got {k}")
    if k > w["emb"].shape[0]:
        raise ValueError(f"beam size {k} exceeds the vocabulary "
                         f"({w['emb'].shape[0]})")


def fused_beam_decode_packed(enc, enc_proj, h0, c0, w: dict, max_length: int,
                             k: int):
    """(preds (B, k, max_length) int32, score (B, k) float32, lens (B, k)
    int32). CPU tensors run the plain version; CUDA tensors run the kernel,
    in one launch."""
    global launch_count
    if enc.device.type == "cpu":
        return fused_beam_decode_plain(enc, enc_proj, h0, c0, w, max_length,
                                       k)
    if enc.device.type != "cuda":
        raise ValueError(f"no fused beam decode for device {enc.device}")
    _check_beam(enc, enc_proj, h0, c0, w, k)
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    hdim = h0.shape[-1]
    v, d = w["emb"].shape
    lib = _library()
    smem = lib.sd_fused_beam_smem(k, p, e, a, hdim, d, v)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"beam size {k} needs {smem} bytes of shared memory "
                         f"per block at these widths; the limit is "
                         f"{_SMEM_LIMIT}")
    dev = enc.device
    preds = torch.full((b, k, max_length), PAD, dtype=torch.int32, device=dev)
    score = torch.empty((b, k), dtype=torch.float32, device=dev)
    lens = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return preds, score, lens
    # Back-pointers: each step's parent and written token for every beam.
    parent = torch.empty((b, max(max_length, 1), k), dtype=torch.int32,
                         device=dev)
    written = torch.empty_like(parent)
    ptr = ctypes.c_void_p
    rc = lib.sd_fused_beam_decode(
        _DTYPE_CODE[enc.dtype], ptr(enc.data_ptr()),
        ptr(enc_proj.data_ptr()), ptr(h0.data_ptr()), ptr(c0.data_ptr()),
        *(ptr(w[n].data_ptr()) for n in STEP_WEIGHTS),
        ptr(preds.data_ptr()), ptr(score.data_ptr()), ptr(lens.data_ptr()),
        ptr(parent.data_ptr()), ptr(written.data_ptr()),
        b, p, e, a, hdim, d, v, k, max_length,
        ptr(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"fused beam decode launch failed: CUDA error "
                           f"{rc}")
    launch_count += 1
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
    preds, score, lens = fused_beam_decode_packed(
        enc_seq, enc_proj, h0.contiguous(), c0.contiguous(),
        decoder.weights(enc_seq.dtype), max_length, beam_size)
    return select_beam(preds, score, lens, length_penalty)

"""K1: the fused greedy decode, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
fused_decode.py`` (``_kernel`` and ``_fused_greedy_decode_tpu``), which
runs every greedy step for a block of rows in one program. The CUDA source
is ``csrc/fused_decode.cu``; its header says what bounds it on an H100 and
what the design does about that. In short: the step streams about 8 MB of
weights, which stay in the 50 MB L2 cache; each block owns a few rows and
runs the whole loop for them; blocks never synchronise with each other.

Beside the kernel is its plain version, :func:`fused_greedy_decode_plain`,
which steps the same loop in Python with PyTorch ops. The wrapper
:func:`fused_greedy_decode_packed` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``launch_count`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from stroke_derenderer_tpu_torch.config import PAD
from stroke_derenderer_tpu_torch.models.decoder import (
    F32_WEIGHTS, STEP_WEIGHTS, decode_step, greedy_loop,
)

# Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MATRICES = ("watt", "v", "wf", "wx", "wh", "wfc")


def fused_greedy_decode_plain(enc, enc_proj, h0, c0, w: dict,
                              max_length: int, return_gaps: bool = False):
    """The kernel's function in PyTorch ops, one Python iteration per step.

    enc (B, P, E), enc_proj (B, P, A), h0 and c0 (B, H) in the stream dtype;
    ``w`` from ``AttentiveDecoder.weights``. Returns (B, max_length) int32
    tokens; with ``return_gaps`` also the (B, max_length) float32 gap
    between the two largest logits at each step (inf where not decoded)."""
    # decode_step sums in float64: convert the matrices and the encoder
    # sequence once rather than at every step.
    w = {k: (t.double() if k in _MATRICES else t) for k, t in w.items()}
    enc = enc.double()
    return greedy_loop(
        lambda emb, h, c: decode_step(w, enc, enc_proj, emb, h, c),
        w["emb"], h0, c0, max_length, return_gaps)


def _library():
    from stroke_derenderer_tpu_torch.kernels.build import load_library
    lib = load_library("fused_decode")
    lib.sd_fused_greedy_decode.restype = ctypes.c_int
    lib.sd_fused_greedy_decode.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
        + [ctypes.c_void_p])
    lib.sd_fused_decode_rows.restype = ctypes.c_int
    lib.sd_fused_decode_rows.argtypes = []
    return lib


def rows_per_block() -> int:
    """Decode rows each block of the kernel owns (builds the kernel)."""
    return int(_library().sd_fused_decode_rows())


def _check(enc, enc_proj, h0, c0, w: dict) -> None:
    dt = enc.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"fused decode streams float32 or bfloat16, not {dt}")
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    hdim = h0.shape[-1]
    v, d = w["emb"].shape
    want = {"enc_proj": (enc_proj, (b, p, a)), "h0": (h0, (b, hdim)),
            "c0": (c0, (b, hdim)), "watt": (w["watt"], (hdim, a)),
            "batt": (w["batt"], (a,)), "v": (w["v"], (a,)),
            "bv": (w["bv"], (1,)), "wf": (w["wf"], (hdim, e)),
            "bf": (w["bf"], (e,)), "wx": (w["wx"], (d + e, 4 * hdim)),
            "wh": (w["wh"], (hdim, 4 * hdim)),
            "blstm": (w["blstm"], (4 * hdim,)), "wfc": (w["wfc"], (hdim, v)),
            "bfc": (w["bfc"], (v,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    for name, t in [("enc", enc), ("enc_proj", enc_proj), ("h0", h0),
                    ("c0", c0)] + [(k, w[k]) for k in STEP_WEIGHTS]:
        want_dt = torch.float32 if name in F32_WEIGHTS else dt
        if t.dtype != want_dt:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want_dt}")
        if t.device != enc.device:
            raise ValueError(f"{name} is on {t.device}, enc on {enc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if any(n % 4 for n in (e, a, hdim, d)):
        raise ValueError(f"E, A, H and D must be multiples of 4, got "
                         f"{(e, a, hdim, d)}")


def fused_greedy_decode_packed(enc, enc_proj, h0, c0, w: dict,
                               max_length: int):
    """(B, max_length) int32 greedy tokens. CPU tensors run the plain
    version; CUDA tensors run the kernel, in one launch."""
    global launch_count
    if enc.device.type == "cpu":
        return fused_greedy_decode_plain(enc, enc_proj, h0, c0, w, max_length)
    if enc.device.type != "cuda":
        raise ValueError(f"no fused decode for device {enc.device}")
    _check(enc, enc_proj, h0, c0, w)
    b, p, e = enc.shape
    preds = torch.full((b, max_length), PAD, dtype=torch.int32,
                       device=enc.device)
    if b == 0 or max_length == 0:
        return preds
    lib = _library()
    v, d = w["emb"].shape
    ptr = ctypes.c_void_p
    rc = lib.sd_fused_greedy_decode(
        _DTYPE_CODE[enc.dtype], ptr(enc.data_ptr()),
        ptr(enc_proj.data_ptr()), ptr(h0.data_ptr()), ptr(c0.data_ptr()),
        *(ptr(w[k].data_ptr()) for k in STEP_WEIGHTS),
        ptr(preds.data_ptr()), b, p, e, enc_proj.shape[-1], h0.shape[-1], d,
        v, max_length,
        ptr(torch.cuda.current_stream(enc.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"fused greedy decode launch failed: CUDA error "
                           f"{rc}")
    launch_count += 1
    return preds


def fused_greedy_decode(decoder, enc_seq, max_length: int):
    """Counterpart of the JAX ``fused_greedy_decode``: the attention
    projection and the initial state from the decoder, then the fused loop.
    Same (B, max_length) int32 output as ``models.decoder.greedy_decode``."""
    enc_seq = enc_seq.contiguous()
    enc_proj = decoder.project_encoding(enc_seq).contiguous()
    h0, c0 = decoder.init_state(enc_seq)
    return fused_greedy_decode_packed(enc_seq, enc_proj, h0.contiguous(),
                                      c0.contiguous(),
                                      decoder.weights(enc_seq.dtype),
                                      max_length)

"""K3: the attention and gate of one decode step, as a CUDA kernel for
Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
decode_attention.py`` (``_kernel`` and ``_fused_attention_gate_tpu``). For
one step of a batch of rows it computes

    alpha = softmax_p(v . relu(enc_proj + h W_att + b_att) + b_v)    (B, P)
    out   = sigmoid(h W_f + b_f) * sum_p alpha_p enc_p                (B, E)

and returns ``(out, alpha)``, both float32. The CUDA source is
``csrc/decode_attention.cu``; its header says what bounds it on an H100.

:func:`fused_attention_gate_plain` is its plain version. With
``stream_dtype=None`` it is the math of the JAX package's
``fused_attention_gate_reference`` in the inputs' (promoted) dtype, which
is what the JAX package runs off the TPU. With ``stream_dtype=
torch.bfloat16`` it is the kernel's function: every input cast to
bfloat16, float32 arithmetic, and ``b_v`` left out because it cancels in
the softmax. The dispatcher :func:`fused_attention_gate` takes the plain
version (``stream_dtype=None``) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launch_count`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0


def fused_attention_gate_plain(enc, enc_proj, h, w_att, b_att, v, b_v, w_f,
                               b_f, stream_dtype=None):
    """enc (B, P, E), enc_proj (B, P, A), h (B, D), w_att (D, A), b_att
    (A,), v (A,), b_v (1,), w_f (D, E), b_f (E,) -> (out (B, E), alpha
    (B, P)), float32."""
    args = (enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f)
    if stream_dtype is not None:
        enc, enc_proj, h, w_att, b_att, v, w_f, b_f = (
            t.to(stream_dtype).float()
            for t in (enc, enc_proj, h, w_att, b_att, v, w_f, b_f))
        scores = torch.relu(enc_proj + (h @ w_att + b_att)[:, None, :]) @ v
    else:
        dt = functools.reduce(torch.promote_types, (t.dtype for t in args))
        enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f = (
            t.to(dt) for t in args)
        att = enc_proj + (h @ w_att + b_att)[:, None, :]
        scores = torch.relu(att) @ v + b_v
    alpha = torch.softmax(scores.float(), dim=1)
    awe = torch.bmm(alpha[:, None, :], enc.float())[:, 0]
    gate = torch.sigmoid((h @ w_f + b_f).float())
    return gate * awe, alpha


def _library():
    from stroke_derenderer_tpu_torch.kernels.build import load_library
    lib = load_library("decode_attention")
    lib.sd_attention_gate.restype = ctypes.c_int
    lib.sd_attention_gate.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def _check(enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f) -> None:
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    d = h.shape[-1]
    want = {"enc_proj": (enc_proj, (b, p, a)), "h": (h, (b, d)),
            "w_att": (w_att, (d, a)), "b_att": (b_att, (a,)),
            "v": (v, (a,)), "b_v": (b_v, (1,)), "w_f": (w_f, (d, e)),
            "b_f": (b_f, (e,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != enc.device:
            raise ValueError(f"{name} is on {t.device}, enc on {enc.device}")
    if p == 0:
        raise ValueError("no encoder positions to attend over")


def fused_attention_gate(enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f):
    """``(out, alpha)`` for one decode step. CPU tensors run the plain
    version in their own dtype; CUDA tensors run the kernel on bfloat16
    streams, in one launch."""
    global launch_count
    if enc.device.type == "cpu":
        return fused_attention_gate_plain(enc, enc_proj, h, w_att, b_att, v,
                                          b_v, w_f, b_f)
    if enc.device.type != "cuda":
        raise ValueError(f"no fused attention for device {enc.device}")
    _check(enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f)
    enc, enc_proj, h, w_att, b_att, v, w_f, b_f = (
        t.to(torch.bfloat16).contiguous()
        for t in (enc, enc_proj, h, w_att, b_att, v, w_f, b_f))
    b, p, e = enc.shape
    out = torch.empty((b, e), dtype=torch.float32, device=enc.device)
    alpha = torch.empty((b, p), dtype=torch.float32, device=enc.device)
    if b == 0:
        return out, alpha
    ptr = ctypes.c_void_p
    rc = _library().sd_attention_gate(
        *(ptr(t.data_ptr()) for t in (enc, enc_proj, h, w_att, b_att, v, w_f,
                                      b_f, out, alpha)),
        b, p, e, enc_proj.shape[-1], h.shape[-1],
        ptr(torch.cuda.current_stream(enc.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"fused attention launch failed: CUDA error {rc}")
    launch_count += 1
    return out, alpha

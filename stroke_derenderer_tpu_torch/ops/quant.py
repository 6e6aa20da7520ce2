"""Dynamic int8 quantization of the convolution stacks, counterpart of the
JAX ``ops/quant.py``.

Dynamic symmetric quantization, rounded exactly as the JAX package rounds:
weights per output channel, activations per tensor (one scale over the
whole batch), both scales computed from the live values, so the parameters
stay float and a checkpoint runs in either mode. The int8 x int8 -> int32
contraction is an im2col built from shifted slices of the zero-padded int8
input, then ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM on the
card, int32 sums on the CPU too); the int32 sums are exact, so the result
does not depend on the order of the sums. The dequantization multiplies
by the product of the two scales and rounds once to the input's dtype.

:func:`int8_conv2d` is what the UNet and the encoder call under
``quant="int8"`` (``models.layers.conv``). :func:`int8_linear` is the
``Dense`` counterpart, wired into no model: the decoder stays in its float
dtype, as in the JAX package. Because the activation scale spans the
batch, a row's output under int8 depends on the rows beside it. Under a
mesh (``parallel.mesh.spmd``) the batch is spread over the ranks, and the
activation scale is the max over every rank that holds part of the
tensor, taken before the division, pad rows included: the JAX package's
``jnp.max`` over a dp- (and tp-) sharded input is the same global
reduction, so a sharded int8 run equals the unsharded run over the same
padded batch.
"""

from __future__ import annotations

import torch

from stroke_derenderer_tpu_torch.parallel.mesh import active

# Symmetric int8: +-127 (not -128), so that negation is exact.
_QMAX = 127.0
_EPS = 1e-12
# torch._int_mm on the card: more than 16 rows, K and N multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8

# Calls of :func:`int8_conv2d`, for a caller that checks a path went
# through it.
call_count = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _quantize(x: torch.Tensor, dims=None):
    """Symmetric int8 quantization of ``x`` reduced over ``dims`` (None:
    every axis) -> (int8 q, float32 scale with the reduced axes kept), x ~=
    q * scale. The scale is max|x| / 127 by division, floored at 1e-12;
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The 127 is
    a tensor on x's device: on the card, PyTorch divides by a Python
    scalar as a multiply by its reciprocal, which is a rounding away from
    the division at times. A per-tensor scale (``dims`` None) under a mesh
    is the max over the mesh's ranks."""
    xf = x.float()
    a = xf.abs()
    m = (a.amax().reshape((1,) * xf.ndim) if dims is None
         else a.amax(dim=dims, keepdim=True))
    ctx = active()
    if dims is None and ctx is not None:
        m = ctx.mesh.all_max(m)
    scale = torch.clamp(m / torch.full_like(m, _QMAX), min=_EPS)
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _aligned_rows(m: int, k: int, device) -> torch.Tensor:
    """An (max(m, 17), K rounded up to 8) int8 buffer whose padding (rows
    past m, columns past k) is zero."""
    mp, kp = max(m, _MIN_ROWS), _round_up(k, _ALIGN)
    if (mp, kp) == (m, k):
        return torch.empty((m, k), dtype=torch.int8, device=device)
    buf = torch.empty((mp, kp), dtype=torch.int8, device=device)
    buf[m:].zero_()
    buf[:m, k:].zero_()
    return buf


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K', N) int8 -> (M, N) int32, exact. ``a`` may carry
    zero padding past the K' columns of ``b``. Zero rows and columns pad M
    to at least 17 and K and N to multiples of 8, which ``torch._int_mm``
    needs on the card and which change no sum."""
    m, n, k = a.shape[0], b.shape[1], b.shape[0]
    if a.shape[1] < k:
        raise ValueError(f"a has {a.shape[1]} columns, b {k} rows")
    if a.shape[0] < _MIN_ROWS or a.shape[1] % _ALIGN:
        a_p = _aligned_rows(m, a.shape[1], a.device)
        a_p[:m, :a.shape[1]] = a
        a = a_p
    # B column-major ((N, K) contiguous, transposed): the layout cuBLASLt
    # takes for an int8 product with a row-major A.
    b_t = torch.zeros((_round_up(n, _ALIGN), a.shape[1]), dtype=torch.int8,
                      device=b.device)
    b_t[:n, :k] = b.t()
    return torch._int_mm(a, b_t.t())[:m, :n]


def conv2d_int32(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                 padding=0, groups: int = 1) -> torch.Tensor:
    """The int32 sums of an NCHW int8 convolution: ``xq`` (B, C, H, W),
    ``wq`` (O, C / groups, kh, kw) -> (B, Ho, Wo, O) int32, channels last;
    ``padding`` an int or (rows, columns).
    The im2col holds, for every output pixel, its (kh, kw, C / groups)
    window of the zero-padded input, taken as kh * kw strided slices and
    written straight into the GEMM's aligned buffer."""
    b, c, h, w = xq.shape
    o, cg, kh, kw = wq.shape
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    xp = torch.zeros((b, h + 2 * ph, w + 2 * pw, c),
                     dtype=torch.int8, device=xq.device)
    xp[:, ph:ph + h, pw:pw + w] = xq.permute(0, 2, 3, 1)
    m, og, k = b * ho * wo, o // groups, kh * kw * cg
    out = torch.empty((b, ho, wo, o), dtype=torch.int32, device=xq.device)
    for g in range(groups):
        buf = _aligned_rows(m, k, xq.device)
        cols = buf[:m].view(b, ho, wo, -1)[..., :k].unflatten(
            -1, (kh * kw, cg))
        for i in range(kh):
            for j in range(kw):
                cols[:, :, :, i * kw + j] = xp[
                    :, i:i + stride * (ho - 1) + 1:stride,
                    j:j + stride * (wo - 1) + 1:stride, g * cg:(g + 1) * cg]
        wmat = wq[g * og:(g + 1) * og].permute(2, 3, 1, 0).reshape(k, og)
        out[..., g * og:(g + 1) * og] = int_mm(buf, wmat)[:m].view(
            b, ho, wo, og)
    return out


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, None, stride, padding, groups=groups)`` (NCHW, no
    bias) with an int8 contraction, the JAX ``int8_conv_general_dilated``:
    ``x`` quantized per tensor, ``w`` per output channel, the int32 sums
    times (x_scale * w_scale) in float32, rounded to ``x.dtype``. ``w``
    is expected in ``x.dtype`` already, as flax promotes its kernel
    before the injected conv sees it. Returns a contiguous NCHW tensor."""
    global call_count
    call_count += 1
    wq, w_scale = _quantize(w, (1, 2, 3))     # (O, 1, 1, 1)
    xq, x_scale = _quantize(x)                # (1, 1, 1, 1)
    acc = conv2d_int32(xq, wq, stride, padding, groups)
    y = acc.float() * (x_scale.reshape(1, 1, 1, 1)
                       * w_scale.reshape(1, 1, 1, -1))
    return y.to(x.dtype).permute(0, 3, 1, 2).contiguous()


def int8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis with ``w`` the (in, out) kernel of a
    flax ``Dense``, with an int8 contraction (the JAX ``int8_dot_general``
    on its Dense pattern): x per tensor, w per column. Any other ``w`` (not
    2-D) falls back to the float ``torch.matmul``, as the JAX function
    falls back to ``lax.dot_general``."""
    if w.ndim != 2:
        return torch.matmul(x, w)
    wq, w_scale = _quantize(w, (0,))          # (1, out)
    xq, x_scale = _quantize(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y = acc.float() * (x_scale.reshape(1, 1) * w_scale)
    return y.to(x.dtype).reshape(x.shape[:-1] + (w.shape[1],))


def conv_injection(quant: str | None):
    """The convolution of a quant mode: None for ``'none'``, ``''`` or
    None (the float ``F.conv2d``), :func:`int8_conv2d` for ``'int8'``."""
    if quant in (None, "", "none"):
        return None
    if quant == "int8":
        return int8_conv2d
    raise ValueError(f"unknown quant mode: {quant!r}")


def dot_injection(quant: str | None):
    """The Dense product of a quant mode: None for ``'none'``, ``''`` or
    None, :func:`int8_linear` for ``'int8'``."""
    if quant in (None, "", "none"):
        return None
    if quant == "int8":
        return int8_linear
    raise ValueError(f"unknown quant mode: {quant!r}")

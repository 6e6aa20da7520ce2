"""Operations and bytes of the pipeline's work, worked out from shapes
(the glyph encoder's in its family, ``encoders/<family>.py``).

Nothing here reads the program's own counters. Floating-point operations
are counted as ``torch.utils.flop_counter.FlopCounterMode`` counts them,
two per multiply-add of every convolution and matrix product (elementwise
work and normalisations are not counted), so that the tests can hold
these sums against it at small shapes.

:func:`decode_cost` is a frozen copy of ``chip_smoke.py``'s ``k1_cost``
and ``k2_cost``, taken apart from tensors: the bytes each decode kernel
must read once and write once, and its operations for the steps the rows
(or beams) needed, as the outputs show them, never the largest number of
steps.
"""

from __future__ import annotations

import encoders

# The chip's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# full 700 W power limit): operations per second by stream type and the
# HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def conv(n, cin, cout, k, h_out, w_out) -> int:
    return 2 * n * cin * cout * k * k * h_out * w_out


def unet_flops(features, bottleneck: int, channels: int, h: int, w: int) -> int:
    """One (h, w, channels) tile through the attention-UNet."""
    total, cin = 0, channels
    for i, f in enumerate(features):
        hh, ww = h >> i, w >> i
        total += conv(1, cin, f, 3, hh, ww) + conv(1, f, f, 3, hh, ww)
        cin = f
    n = len(features)
    hh, ww = h >> n, w >> n
    total += conv(1, cin, bottleneck, 3, hh, ww) + conv(1, bottleneck, bottleneck, 3, hh, ww)
    cin = bottleneck
    for i in reversed(range(n)):
        f = features[i]
        hh, ww = h >> i, w >> i
        inter = max(f // 2, 4)
        total += conv(1, cin, f, 1, hh, ww)                 # 2x2 stride 2, transposed
        total += 2 * conv(1, f, inter, 1, hh, ww) + conv(1, inter, 1, 1, hh, ww)
        total += conv(1, 2 * f, f, 3, hh, ww) + conv(1, f, f, 3, hh, ww)
        cin = f
    return total + conv(1, features[0], 1, 1, h, w)


def projection_flops(positions: int, cin: int, cout: int) -> int:
    """The projection head over one row's positions."""
    return 2 * positions * cin * cout


def decoder_row_flops(p: int, e: int, a: int, hdim: int) -> int:
    """Once per row: the encoder sequence's attention projection and the
    initial state."""
    return 2 * p * e * a + 2 * 2 * e * hdim


def decoder_step_flops(p: int, e: int, a: int, hdim: int, d: int, v: int) -> int:
    """One decode step of one row (or one beam)."""
    return (2 * hdim * a + 2 * p * a + 2 * p * e + 2 * hdim * e
            + 2 * (d + e) * 4 * hdim + 2 * hdim * 4 * hdim + 2 * hdim * v)


def decoder_weight_bytes(e: int, a: int, hdim: int, d: int, v: int,
                         stream_bytes: int) -> int:
    """The step's weights as the decode kernels read them: the vocabulary
    head in float32, the rest in the stream type."""
    stream = (hdim * a + a + a + 1 + hdim * e + e + (d + e) * 4 * hdim
              + hdim * 4 * hdim + 4 * hdim + v * d)
    return stream * stream_bytes + (hdim * v + v) * 4


def decode_cost(rows: int, steps, k: int, p: int, e: int, a: int, hdim: int,
                d: int, v: int, max_length: int, dtype: str) -> dict:
    """Bytes once, operations and bound of one K1 (``k`` = 1) or K2
    launch over ``rows`` rows (images), ``steps`` the steps each row's
    search ran (greedy: its tokens up to its EOS; beam: until its last beam
    finished)."""
    sb = 2 if dtype == "bfloat16" else 4
    wbytes = decoder_weight_bytes(e, a, hdim, d, v, sb)
    io = (rows * p * (e + a) * sb + 2 * rows * hdim * sb
          + rows * k * max_length * 4 + (rows * k * 8 if k > 1 else 0))
    step = (2 * hdim * a + 2 * hdim * e + 2 * (d + e) * 4 * hdim
            + 2 * hdim * 4 * hdim + 2 * hdim * v + 3 * p * a + 2 * p * e
            + (5 * v if k > 1 else 0))
    flops = int(sum(steps)) * k * step
    by_bytes = (wbytes + io) / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    return {"bytes_once": wbytes + io, "flops": flops,
            "bound_s": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def decode_bound_s(calls, strokes: dict, k: int) -> float:
    """The least time the card could take for the decode launches of the
    traced ``calls`` (one launch a call; ``k`` = 1 for K1, the beam width
    for K2), at configuration ``strokes``'s widths."""
    fam = encoders.family(strokes["encoder_arch"])
    e = strokes["projection_dim"] or fam.width(strokes)
    return sum(decode_cost(c["rows"], c["steps"], k, fam.positions(strokes), e,
                           strokes["attention_dim"], strokes["decoder_dim"],
                           strokes["embed_dim"], 3 + 2 * strokes["image_size"],
                           strokes["max_length"], strokes["compute_dtype"])["bound_s"]
               for c in calls if c["rows"])

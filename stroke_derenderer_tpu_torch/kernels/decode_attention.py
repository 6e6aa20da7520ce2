"""K3: the attention and gate of one decode step, as a CUDA kernel for
Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
decode_attention.py`` (``_kernel`` and ``_fused_attention_gate_tpu``). For
one step of a batch of rows it computes

    alpha = softmax_p(v . relu(enc_proj + h W_att + b_att) + b_v)    (B, P)
    out   = sigmoid(h W_f + b_f) * sum_p alpha_p enc_p                (B, E)

and returns ``(out, alpha)``, both float32. The CUDA source is
``csrc/decode_attention.cu``; its header says what bounds it on an H100 and
how the design answers it: one thread-block cluster of ``C`` CTAs per group
of rows, each CTA owning a slice of the weight columns, of the positions
and of the output columns, with the softmax split over the positions and
combined through distributed shared memory.

This module holds the host side of that design, all of it plain Python
that runs on the CPU: :func:`attention_plan` (which rows each cluster
takes, and which columns, positions and output columns each CTA owns),
:func:`pack_attention_weights` (the bfloat16 layout the kernel reads,
cached per decoder by :func:`attention_weights`) and
:func:`fused_attention_gate_split`, the kernel's own order of work in
PyTorch: local softmaxes over position slices, rescaled by
``exp(m_c - m)`` and combined.

:func:`fused_attention_gate_plain` is the plain version. With
``stream_dtype=None`` it is the math of the JAX package's
``fused_attention_gate_reference`` in the inputs' (promoted) dtype, which
is what the JAX package runs off the TPU. With ``stream_dtype=
torch.bfloat16`` it is the kernel's function: every input cast to
bfloat16, float32 arithmetic, and ``b_v`` left out because it cancels in
the softmax. The dispatcher :func:`fused_attention_gate` takes the plain
version (``stream_dtype=None``) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launch_count`` counts its
launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# Launches of the CUDA kernel by fused_attention_gate since import (or since
# a caller reset it).
launch_count = 0
# Cluster sizes (CTAs per row group) the wrapper chooses from: the larger
# while the card holds a cluster of it for every row, else the smaller
# (measured on an H100: PERF.md, section 6).
CLUSTER_SIZES = (16, 8)
MAX_CLUSTER = 16
MAX_GROUPS = 512     # clusters of one launch (csrc/decode_attention.cu)
MAX_D = 1024         # h's width: up to 4 chunks of 16 bytes per lane
H100_SMS = 132
# Indices of the C entry's int array ``dims`` (``enum Dim``).
DIMS = ("B", "P", "E", "A", "D", "C", "G", "h_f32")


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def attention_plan(b: int, p: int, a: int, e: int, cluster: int,
                   clusters: int | None = None) -> dict:
    """Who does what in one launch, as int32 start offsets:

    - ``rows`` (G + 1): cluster g takes rows ``rows[g]:rows[g + 1]``, with
      G = min(b, clusters) clusters (``clusters`` defaults to as many as fit
      on an H100, 132 // cluster) and the rows as even as the counts allow;
    - ``columns`` (cluster + 1): CTA c owns columns ``columns[c]:columns[c +
      1]`` of [W_att | W_f] (0..a-1 W_att, a..a+e-1 W_f), in whole groups of
      8 so that a CTA's slice is 16-byte aligned;
    - ``positions`` (cluster + 1): CTA c owns those positions of 0..p-1;
    - ``outputs`` (cluster + 1): CTA c writes those columns of ``out``, in
      whole groups of 4 (the kernel moves them between CTAs 16 bytes at a
      time).

    Every range is contiguous; a CTA's range may be empty (more CTAs than
    positions)."""
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster size {cluster} not in 1..{MAX_CLUSTER}")
    if clusters is None:
        clusters = H100_SMS // cluster
    g = min(b, clusters, MAX_GROUPS)
    ctas = np.arange(cluster + 1, dtype=np.int64)
    units = -(-(a + e) // 8)
    return {"rows": (np.arange(g + 1, dtype=np.int64) * b
                     // max(g, 1)).astype(np.int32),
            "columns": np.minimum(8 * (ctas * units // cluster),
                                  a + e).astype(np.int32),
            "positions": (ctas * p // cluster).astype(np.int32),
            "outputs": np.minimum(4 * (ctas * -(-e // 4) // cluster),
                                  e).astype(np.int32)}


def pack_attention_weights(w_att, b_att, v, w_f, b_f) -> dict:
    """The bfloat16 layout the kernel reads, on the weights' device:

    - ``m1`` (A + E, Dp): column j of [W_att | W_f] as row j, its D values
      contiguous and zero-padded to Dp, a multiple of 8. The columns a CTA
      owns (:func:`attention_plan`) are one contiguous, 16-byte-aligned
      stretch;
    - ``bias`` (A + E,): [b_att | b_f];
    - ``v`` (A,).

    Each value is the input's own rounding to bfloat16 (``Tensor.to``)."""
    d, a = w_att.shape
    e = w_f.shape[1]
    m1 = torch.zeros((a + e, _round8(d)), dtype=torch.bfloat16,
                     device=w_att.device)
    m1[:a, :d] = w_att.t().to(torch.bfloat16)
    m1[a:, :d] = w_f.t().to(torch.bfloat16)
    return {"m1": m1,
            "bias": torch.cat([b_att, b_f]).to(torch.bfloat16).contiguous(),
            "v": v.to(torch.bfloat16).contiguous()}


def attention_weights(decoder) -> dict:
    """:func:`pack_attention_weights` of the decoder's attention parameters,
    made once per model: cached on the decoder until one of them is
    replaced or changed in place."""
    from stroke_derenderer_tpu_torch.models.decoder import ATTENTION_WEIGHTS
    params = [getattr(decoder, k) for k in ATTENTION_WEIGHTS if k != "bv"]
    key = tuple((t.data_ptr(), t._version, t.device) for t in params)
    cached = decoder.__dict__.get("_attention_weights")
    if cached is None or cached[0] != key:
        cached = (key, pack_attention_weights(*params))
        decoder.__dict__["_attention_weights"] = cached
    return cached[1]


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


def fused_attention_gate_split(enc, enc_proj, h, packed: dict,
                               cluster: int = 16,
                               clusters: int | None = None):
    """The kernel's order of work in PyTorch, float32 on bfloat16 streams,
    on ``packed`` (:func:`pack_attention_weights`) and the plan of
    :func:`attention_plan`: for each cluster's rows, every CTA computes its
    columns of [dec | gate] from its slice of ``m1``; scores its positions
    and keeps their max m_c, sum s_c = sum exp(score - m_c) and partial
    attended vector; then the partials are combined with the factors
    exp(m_c - m) / sum_c s_c exp(m_c - m). Returns (out (B, E), alpha
    (B, P)), float32."""
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    d = h.shape[-1]
    plan = attention_plan(b, p, a, e, cluster, clusters)
    stream = lambda t: t.to(torch.bfloat16).float()
    enc, enc_proj, h = stream(enc), stream(enc_proj), stream(h)
    m1, bias, v = (packed[k].float() for k in ("m1", "bias", "v"))
    cols, pos = plan["columns"], plan["positions"]
    out = torch.empty((b, e), dtype=torch.float32, device=enc.device)
    alpha = torch.empty((b, p), dtype=torch.float32, device=enc.device)
    rows = plan["rows"]
    for g in range(len(rows) - 1):
        r = slice(int(rows[g]), int(rows[g + 1]))
        part = torch.cat([h[r] @ m1[j0:j1, :d].t() + bias[j0:j1]
                          for j0, j1 in zip(cols[:-1].tolist(),
                                            cols[1:].tolist())], dim=1)
        dec, gate = part[:, :a], torch.sigmoid(part[:, a:])
        scores, ms, sums, awes = [], [], [], []
        for p0, p1 in zip(pos[:-1].tolist(), pos[1:].tolist()):
            sc = torch.relu(enc_proj[r, p0:p1] + dec[:, None, :]) @ v
            m_c = (sc.max(dim=1).values if p1 > p0 else
                   torch.full((sc.shape[0],), -torch.inf, device=sc.device))
            ex = torch.exp(sc - m_c[:, None])
            scores.append(sc)
            ms.append(m_c)
            sums.append(ex.sum(dim=1))
            awes.append(torch.bmm(ex[:, None, :], enc[r, p0:p1])[:, 0])
        ms = torch.stack(ms)                        # (C, rows)
        m = ms.max(dim=0).values
        f = torch.exp(ms - m)
        total = (torch.stack(sums) * f).sum(dim=0)
        scale = f / total
        out[r] = gate * (torch.stack(awes) * scale[:, :, None]).sum(dim=0)
        alpha[r] = torch.cat([torch.exp(sc - m[:, None]) / total[:, None]
                              for sc in scores], dim=1)
    return out, alpha


# --- the card ----------------------------------------------------------------

_BOUND: set = set()


def _library():
    from stroke_derenderer_tpu_torch.kernels.build import load_library
    lib = load_library("decode_attention")
    if id(lib) not in _BOUND:
        lib.sd_attention_config.restype = ctypes.c_int
        lib.sd_attention_config.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sd_attention_gate.restype = ctypes.c_int
        lib.sd_attention_gate.argtypes = [ctypes.c_void_p] * 4
        lib.sd_cluster_probe.restype = ctypes.c_int
        lib.sd_cluster_probe.argtypes = [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 2
        _BOUND.add(id(lib))
    return lib


# (device, C, P, E, A, D) -> launch configuration (kernel_config).
_CONFIGS: dict = {}
# (B, P, E, A, C, G) -> the plan as the C entry's int array.
_PLANS: dict = {}


def kernel_config(device, cluster: int, p: int, e: int, a: int,
                  d: int) -> dict:
    """The card's launch configuration for these widths, cached:
    ``clusters`` (how many clusters of ``cluster`` CTAs it holds at once),
    ``smem`` (bytes of shared memory a CTA), ``row_tile``, ``stages`` (of
    the encoder ring), ``threads`` and ``kmax`` (16-byte chunks of a weight
    column per lane). Raises ``RuntimeError`` if the card can hold no such
    cluster."""
    key = (str(device), cluster, p, e, a, d)
    if key not in _CONFIGS:
        dims = (ctypes.c_int * len(DIMS))(0, p, e, a, d, cluster, 0, 0)
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            rc = _library().sd_attention_config(
                ctypes.cast(dims, ctypes.c_void_p),
                ctypes.cast(out, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"fused attention: no launch configuration "
                               f"for C={cluster}, P={p}, E={e}, A={a}, "
                               f"D={d}: CUDA error {rc}")
        if out[0] == 0:
            raise RuntimeError(f"fused attention: the card holds no cluster "
                               f"of {cluster} CTAs with {out[1]} bytes of "
                               f"shared memory each")
        _CONFIGS[key] = dict(zip(("clusters", "smem", "row_tile", "stages",
                                  "threads", "kmax"), out))
    return _CONFIGS[key]


def choose_cluster(device, b: int, p: int, e: int, a: int, d: int) -> int:
    """The cluster size for B = b rows: the first of ``CLUSTER_SIZES`` of
    which the card holds at least b clusters at once, else the last."""
    for c in CLUSTER_SIZES[:-1]:
        if b <= kernel_config(device, c, p, e, a, d)["clusters"]:
            return c
    return CLUSTER_SIZES[-1]


def _plan_array(b, p, e, a, cluster, clusters):
    key = (b, p, e, a, cluster, clusters)
    if key not in _PLANS:
        plan = attention_plan(b, p, a, e, cluster, clusters)
        flat = np.concatenate([plan[k] for k in ("rows", "columns",
                                                 "positions", "outputs")])
        _PLANS[key] = (len(plan["rows"]) - 1,
                       (ctypes.c_int * len(flat))(*flat.tolist()))
    return _PLANS[key]


# The phase clock's points (``enum Stamp`` in csrc/decode_attention.cu):
# CTA 0 reads its cycle counter at kernel entry and after each of these
# points of its first row tile ("wait" to "awe": of that tile's first row),
# and the global timer at entry and at the end.
STAMPS = ("entry", "loads", "init", "issued", "hstored", "staged",
          "first_row", "project", "barrier1", "wait", "scores", "softmax",
          "awe", "positions", "barrier2", "combine", "timer_entry", "timer_exit")


def phase_us(stamps) -> dict:
    """Microseconds from each phase clock point to the next, the cycles
    scaled by the global timer's span from entry to the end. A point CTA 0
    did not pass (it skips a row's phases when it owns no positions) reads
    0 and counts as no time."""
    t = [float(x) for x in stamps]
    n = STAMPS.index("timer_entry")
    for i in range(1, n):
        t[i] = t[i] or t[i - 1]
    us_per_cycle = (t[n + 1] - t[n]) / 1e3 / max(t[n - 1] - t[0], 1.0)
    return {STAMPS[i + 1]: (t[i + 1] - t[i]) * us_per_cycle
            for i in range(n - 1)}


def launch_attention(enc, enc_proj, h, packed: dict, out, alpha,
                     cluster: int | None = None, stamps=None) -> int:
    """One launch of the kernel on prepared tensors (enc, enc_proj bfloat16,
    contiguous, 16-byte aligned; h bfloat16 or float32, contiguous; packed
    from :func:`pack_attention_weights`; out (B, E) and alpha (B, P)
    float32), with no checks and no count; ``cluster`` None takes
    :func:`choose_cluster`. ``stamps`` (int64, one per ``STAMPS`` entry)
    turns on the phase clock. Returns the number of clusters G; raises
    ``RuntimeError`` on a CUDA error."""
    b, p, e = enc.shape
    a, d = enc_proj.shape[-1], h.shape[-1]
    if cluster is None:
        cluster = choose_cluster(enc.device, b, p, e, a, d)
    cfg = kernel_config(enc.device, cluster, p, e, a, d)
    g, plan = _plan_array(b, p, e, a, cluster, cfg["clusters"])
    dims = (ctypes.c_int * len(DIMS))(
        b, p, e, a, d, cluster, g, int(h.dtype == torch.float32))
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in (
        enc, enc_proj, h, packed["m1"], packed["bias"], packed["v"], out,
        alpha)), None if stamps is None else stamps.data_ptr())
    rc = _library().sd_attention_gate(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(dims, ctypes.c_void_p),
        ctypes.cast(plan, ctypes.c_void_p),
        torch.cuda.current_stream(enc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused attention launch failed: CUDA error {rc}")
    return g


def cluster_probe(n: int, cluster: int, clusters: int, exchange: bool,
                  device) -> None:
    """One launch of ``clusters`` clusters of ``cluster`` CTAs that only
    crosses ``n`` cluster barriers (with ``exchange``, each after a read of
    the neighbour CTA's shared memory), to time what a barrier costs."""
    sink = torch.empty(1, dtype=torch.float32, device=device)
    rc = _library().sd_cluster_probe(
        n, cluster, clusters, int(exchange), sink.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cluster probe launch failed: CUDA error {rc}")


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


def check_widths(e: int, a: int, d: int) -> None:
    """The widths the kernel takes: E and A multiples of 8 (16-byte rows
    for the bulk copies and vector loads), D at most ``MAX_D``."""
    for name, n in (("E", e), ("A", a)):
        if n % 8:
            raise ValueError(f"fused attention needs {name} to be a multiple "
                             f"of 8, got {name}={n}")
    if d > MAX_D:
        raise ValueError(f"fused attention needs D <= {MAX_D}, got D={d}")


def _stream(t):
    """t as a contiguous, 16-byte-aligned bfloat16 tensor, cast or copied
    only when it is not one already."""
    if t.dtype != torch.bfloat16 or not t.is_contiguous():
        t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_attention_gate(enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f,
                         packed: dict | None = None,
                         cluster: int | None = None):
    """``(out, alpha)`` for one decode step, after checking that the shapes
    agree and that every tensor lies on enc's device. CPU tensors run the
    plain version in their own dtype; CUDA tensors run the kernel on bfloat16
    streams, in one launch, on ``packed`` (:func:`pack_attention_weights`
    of the five weights, packed here when not given: pass the decoder's
    cached :func:`attention_weights` to skip that), in clusters of
    ``cluster`` CTAs (None: :func:`choose_cluster`)."""
    global launch_count
    _check(enc, enc_proj, h, w_att, b_att, v, b_v, w_f, b_f)
    if enc.device.type == "cpu":
        return fused_attention_gate_plain(enc, enc_proj, h, w_att, b_att, v,
                                          b_v, w_f, b_f)
    if enc.device.type != "cuda":
        raise ValueError(f"no fused attention for device {enc.device}")
    b, p, e = enc.shape
    check_widths(e, enc_proj.shape[-1], h.shape[-1])
    if packed is None:
        packed = pack_attention_weights(w_att, b_att, v, w_f, b_f)
    for name, t in packed.items():
        if t.device != enc.device:
            raise ValueError(f"packed {name} is on {t.device}, enc on "
                             f"{enc.device}")
    enc, enc_proj = _stream(enc), _stream(enc_proj)
    if h.dtype not in (torch.float32, torch.bfloat16):
        h = h.to(torch.bfloat16)
    h = h.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()
    out = torch.empty((b, e), dtype=torch.float32, device=enc.device)
    alpha = torch.empty((b, p), dtype=torch.float32, device=enc.device)
    if b == 0:
        return out, alpha
    launch_attention(enc, enc_proj, h, packed, out, alpha, cluster)
    launch_count += 1
    return out, alpha

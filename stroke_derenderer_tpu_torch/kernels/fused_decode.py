"""K1: the fused greedy decode, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
fused_decode.py`` (``_kernel`` and ``_fused_greedy_decode_tpu``), which
runs every greedy step for a block of rows in one program. The CUDA source
is ``csrc/fused_decode.cu``, on the step engine ``csrc/decode_step.cuh``
that it shares with K2; the header says what bounds a step on an H100 and
what the design does about that. In short: one cooperative launch per
decode call, every block of the grid owning a slice of every matrix's
output columns, four grid barriers per step.

This module also holds the host side of that engine, for K1 and K2 alike:
:func:`pack_step_weights` (the column-major weight layout, made once per
model), :func:`step_plan` (which columns each block owns) and
:func:`launch_step_kernel` (scratch, grid and launch).

Beside the kernel is its plain version, :func:`fused_greedy_decode_plain`,
which steps the same loop in Python with PyTorch ops. The wrapper
:func:`fused_greedy_decode_packed` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``launch_count`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stroke_derenderer_tpu_torch.config import PAD
from stroke_derenderer_tpu_torch.models.decoder import (
    F32_WEIGHTS, STEP_WEIGHTS, decode_step, greedy_loop,
)

# Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0
# Grid barriers per decode step.
BARRIERS_PER_STEP = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MATRICES = ("watt", "v", "wf", "wx", "wh", "wfc")
# The pointer and dimension arrays of the C entry points, in the order of
# ``enum Ptr`` and ``enum Dim`` in csrc/decode_step.cuh.
STEP_POINTERS = (
    "enc", "proj", "h0", "c0", "m1", "fc", "m3",
    "batt", "v", "bv", "bf", "blstm", "emb", "bfc",
    "head_start", "unit_start",
    "h", "c", "dp", "gate", "sc", "awe", "logits", "rows",
    "tok", "parent", "score", "fin", "len", "done", "steps",
    "bp_parent", "bp_write",
    "preds", "score_out", "lens_out", "stamps")
STEP_DIMS = ("B", "P", "E", "A", "H", "D", "V", "K", "max_length")


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def pack_step_weights(w: dict) -> dict:
    """``AttentiveDecoder.weights`` -> the layout the step engine reads
    (counterpart of the JAX ``pack_decoder_weights``). Every output column
    is stored with its K values contiguous, zero-padded to a multiple of 8:

    - ``m1`` (A + E, Hp): the columns of W_att, then those of W_f;
    - ``fc`` (V, Hp) float32: the columns of W_fc;
    - ``m3`` (4H, Xp + Hp): row 4j + g is gate g (i, f, g, o) of LSTM unit
      j: column gH + j of W_x (D + E values, padded to Xp), then the same
      column of W_h (H values, padded to Hp). A block owning unit j reads
      rows 4j to 4j + 3, one contiguous stretch.

    The biases, v and the embedding are passed as they are."""
    hdim = w["watt"].shape[0]
    x = w["wx"].shape[0]
    hp, xp = _round8(hdim), _round8(x)

    def columns(m, kp):
        out = m.new_zeros((m.shape[1], kp))
        out[:, :m.shape[0]] = m.t()
        return out

    m1 = columns(torch.cat([w["watt"], w["wf"]], dim=1), hp)
    # Gate-major (g, j) columns -> unit-major rows 4j + g.
    unit_major = lambda m: m.view(m.shape[0], 4, hdim).transpose(1, 2).reshape(
        m.shape[0], 4 * hdim)
    m3 = torch.cat([columns(unit_major(w["wx"]), xp),
                    columns(unit_major(w["wh"]), hp)], dim=1)
    packed = {"m1": m1.contiguous(), "fc": columns(w["wfc"], hp).contiguous(),
              "m3": m3.contiguous()}
    packed.update({k: w[k] for k in ("batt", "v", "bv", "bf", "blstm", "emb",
                                     "bfc")})
    return packed


def step_weights(decoder, dtype: torch.dtype) -> dict:
    """:func:`pack_step_weights` of ``decoder.weights(dtype)``, made once per
    model and dtype: cached on the decoder until one of its parameters is
    replaced or changed in place."""
    key = (dtype, tuple((t.data_ptr(), t._version, t.device)
                        for t in decoder.parameters()))
    cache = decoder.__dict__.setdefault("_step_weights", {})
    if cache.get(dtype, (None,))[0] != key:
        cache[dtype] = (key, pack_step_weights(decoder.weights(dtype)))
    return cache[dtype][1]


def step_plan(n_blocks: int, a: int, e: int, v: int, hdim: int) -> dict:
    """Which output columns each of ``n_blocks`` blocks owns: block b owns
    the head columns ``head_start[b]:head_start[b + 1]`` (0..A-1 W_att,
    A..A+E-1 W_f, A+E..A+E+V-1 W_fc) and the LSTM units
    ``unit_start[b]:unit_start[b + 1]`` (unit j = gate columns j, H+j, 2H+j,
    3H+j of [W_x; W_h]). Contiguous, as even as the counts allow. int32."""
    blocks = np.arange(n_blocks + 1, dtype=np.int64)
    return {"head_start": (blocks * (a + e + v) // n_blocks).astype(np.int32),
            "unit_start": (blocks * hdim // n_blocks).astype(np.int32)}


def barrier_probe(n: int, grid: int, device) -> None:
    """One cooperative launch of ``grid`` blocks that only crosses ``n``
    grid barriers (to time what a barrier costs)."""
    lib, _, _ = _library("fused_decode")
    lib.sd_barrier_probe.restype = ctypes.c_int
    lib.sd_barrier_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    rc = lib.sd_barrier_probe(n, grid,
                              torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"barrier probe launch failed: CUDA error {rc}")


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


def _library(name: str = "fused_decode"):
    from stroke_derenderer_tpu_torch.kernels.build import load_library
    lib = load_library(name, deps=("decode_step.cuh",))
    entry = {"fused_decode": "sd_fused_greedy_decode",
             "fused_beam": "sd_fused_beam_decode"}[name]
    grid = {"fused_decode": "sd_fused_decode_grid",
            "fused_beam": "sd_fused_beam_grid"}[name]
    getattr(lib, entry).restype = ctypes.c_int
    getattr(lib, entry).argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
    getattr(lib, grid).restype = ctypes.c_int
    getattr(lib, grid).argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]
    return lib, getattr(lib, entry), getattr(lib, grid)


# (kernel, dtype code, widths, K, device) -> (grid, plan tensors on the
# device). The grid depends on the shared memory a block needs, which does
# not depend on B or max_length.
_PLANS: dict = {}


def launch_grid(name: str, dtype: torch.dtype, dims: dict, device) -> tuple:
    """The grid (blocks) of one cooperative launch of kernel ``name``
    ("fused_decode" or "fused_beam") at these dims, and the ownership plan
    for it uploaded to ``device``; cached. Raises if the card cannot run the
    launch (no cooperative launch, or no block fits on an SM)."""
    key = (name, _DTYPE_CODE[dtype], str(device),
           *(dims[k] for k in STEP_DIMS if k not in ("B", "max_length")))
    if key not in _PLANS:
        _, _, grid_fn = _library(name)
        arr = (ctypes.c_int * len(STEP_DIMS))(*(dims[k] for k in STEP_DIMS))
        grid = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = grid_fn(_DTYPE_CODE[dtype], ctypes.cast(arr, ctypes.c_void_p),
                         ctypes.byref(grid))
        if rc != 0:
            raise RuntimeError(f"{name}: the card cannot run the cooperative "
                               f"launch: CUDA error {rc}")
        plan = step_plan(grid.value, dims["A"], dims["E"], dims["V"],
                         dims["H"])
        _PLANS[key] = (grid.value, {k: torch.from_numpy(t).to(device)
                                    for k, t in plan.items()})
    return _PLANS[key]


def launch_step_kernel(name: str, enc, enc_proj, h0, c0, packed: dict,
                       k: int, max_length: int, outputs: dict) -> None:
    """One cooperative launch of K1 (``name`` "fused_decode", k = 1) or K2
    ("fused_beam"): allocates the engine's scratch, fills the pointer array
    in ``STEP_POINTERS`` order (``outputs`` gives preds and, for K2,
    score_out and lens_out; optionally ``stamps``, int64 of at least 3 +
    max_length x phases, for the phase clock) and raises on a non-zero CUDA
    error code."""
    b, p, e = enc.shape
    hdim = h0.shape[-1]
    v, d = packed["emb"].shape
    dims = {"B": b, "P": p, "E": e, "A": enc_proj.shape[-1], "H": hdim,
            "D": d, "V": v, "K": k, "max_length": max_length}
    dev = enc.device
    grid, plan = launch_grid(name, enc.dtype, dims, dev)
    rows = b * k
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    hp = _round8(hdim)
    scratch = {"h": torch.empty((2, rows, hp), **f32),
               "c": torch.empty((2, rows, hdim), **f32),
               "dp": torch.empty((rows, dims["A"]), **f32),
               "gate": torch.empty((rows, e), **f32),
               "sc": torch.empty((rows, (p + 3) // 4 * 4), **f32),
               "awe": torch.empty((rows, e), **f32),
               "logits": torch.empty((rows, v), **f32),
               "rows": torch.empty((grid, 2 * rows), **i32)}
    if name == "fused_beam":
        scratch.update(
            tok=torch.empty(rows, **i32), parent=torch.empty(rows, **i32),
            score=torch.empty(rows, **f32), fin=torch.empty(rows, **i32),
            len=torch.empty(rows, **i32), done=torch.empty(b, **i32),
            steps=torch.empty(b, **i32),
            bp_parent=torch.empty((b, max_length, k), **i32),
            bp_write=torch.empty((b, max_length, k), **i32))
    tensors = {"enc": enc, "proj": enc_proj, "h0": h0, "c0": c0, **packed,
               **plan, **scratch, **outputs}
    ptrs = (ctypes.c_void_p * len(STEP_POINTERS))(
        *(tensors[n].data_ptr() if n in tensors else None
          for n in STEP_POINTERS))
    arr = (ctypes.c_int * len(STEP_DIMS))(*(dims[n] for n in STEP_DIMS))
    _, entry, _ = _library(name)
    rc = entry(_DTYPE_CODE[enc.dtype], ctypes.cast(ptrs, ctypes.c_void_p),
               ctypes.cast(arr, ctypes.c_void_p), grid,
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: cooperative launch failed: CUDA error "
                           f"{rc}")


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
                               max_length: int, packed: dict | None = None):
    """(B, max_length) int32 greedy tokens. CPU tensors run the plain
    version; CUDA tensors run the kernel, in one cooperative launch, on
    ``packed`` (:func:`pack_step_weights` of ``w``, packed here when not
    given)."""
    global launch_count
    if enc.device.type == "cpu":
        return fused_greedy_decode_plain(enc, enc_proj, h0, c0, w, max_length)
    if enc.device.type != "cuda":
        raise ValueError(f"no fused decode for device {enc.device}")
    _check(enc, enc_proj, h0, c0, w)
    preds = torch.full((enc.shape[0], max_length), PAD, dtype=torch.int32,
                       device=enc.device)
    if enc.shape[0] == 0 or max_length == 0:
        return preds
    launch_step_kernel("fused_decode", enc, enc_proj, h0, c0,
                       pack_step_weights(w) if packed is None else packed, 1,
                       max_length,
                       {"preds": preds})
    launch_count += 1
    return preds


def fused_greedy_decode(decoder, enc_seq, max_length: int):
    """Counterpart of the JAX ``fused_greedy_decode``: the attention
    projection and the initial state from the decoder, then the fused loop
    on the decoder's weights, packed once (:func:`step_weights`). Same
    (B, max_length) int32 output as ``models.decoder.greedy_decode``."""
    enc_seq = enc_seq.contiguous()
    enc_proj = decoder.project_encoding(enc_seq).contiguous()
    h0, c0 = decoder.init_state(enc_seq)
    dt = enc_seq.dtype
    packed = step_weights(decoder, dt) if enc_seq.is_cuda else None
    return fused_greedy_decode_packed(enc_seq, enc_proj, h0.contiguous(),
                                      c0.contiguous(), decoder.weights(dt),
                                      max_length, packed)


def decode_sharded(decode, enc_seq, max_length: int, mesh,
                   batch: int | None = None):
    """The sharded contract of K1 and K2 (the JAX ``shard_map`` over
    'dp'): ``enc_seq`` holds this rank's rows of a global batch of
    ``batch`` rows (default dp x its rows), which dp must divide: the first
    of the rank's ``batch // dp`` rows, the rest padding. ``decode(rows)``
    -> (rows, max_length) int32 tokens runs on the rank's rows (one launch;
    none when it has no rows), the padding gets PAD, and every rank gets
    the (batch, max_length) tokens of all of them, gathered over its dp
    group in global row order. Rows never interact, so no other collective
    is needed; the ranks of one tp group decode the same rows, as
    replicas."""
    dp = mesh.shape["dp"]
    batch = enc_seq.shape[0] * dp if batch is None else batch
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by dp={dp}")
    local = batch // dp
    if enc_seq.shape[0] > local:
        raise ValueError(f"{enc_seq.shape[0]} rows on this rank, more than "
                         f"batch {batch} / dp {dp}")
    out = torch.full((local, max_length), PAD, dtype=torch.int32,
                     device=enc_seq.device)
    if enc_seq.shape[0]:
        out[:enc_seq.shape[0]] = decode(enc_seq)
    return mesh.all_gather(out, "dp", 0)


def fused_greedy_decode_sharded(decoder, enc_seq, max_length: int, mesh,
                                batch: int | None = None):
    """:func:`fused_greedy_decode` with the glyph batch sharded over the
    mesh's dp ranks (counterpart of the JAX
    ``fused_greedy_decode_sharded``): :func:`decode_sharded`'s contract,
    one K1 launch per rank (the plain version on the CPU)."""
    return decode_sharded(
        lambda rows: fused_greedy_decode(decoder, rows, max_length),
        enc_seq, max_length, mesh, batch)

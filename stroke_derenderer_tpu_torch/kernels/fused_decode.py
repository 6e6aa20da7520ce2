"""K1: the fused greedy decode, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``stroke_derenderer_tpu/kernels/
fused_decode.py`` (``_kernel`` and ``_fused_greedy_decode_tpu``), which
runs every greedy step for a block of rows in one program. The CUDA source
is ``csrc/fused_decode.cu``, on the step engine ``csrc/decode_step.cuh``
that it shares with K2; the header says what bounds a step on an H100 and
what the design does about that. In short: one cooperative launch per
decode call, every block of the grid owning a slice of every matrix's
output columns, four grid barriers per step. The stream type picks the
path of its LSTM and head phases when the kernel is built (``ENGINES``):
bfloat16 streams run them on the tensor cores over weight slices resident
in shared memory ("mma"), float32 streams on CUDA cores in float64
("f64").

This module also holds the host side of that engine, for K1 and K2 alike:
:func:`pack_step_weights` (the column-major weight layout, made once per
model), :func:`step_plan` (which columns each block owns),
:func:`mma_slices` and :func:`mma_plan` (the tensor-core path's resident
slices and shared-memory plan), :func:`att_tiling` (how the attention
phases tile a step, as the kernel works it out from the step's live rows)
and :func:`launch_step_kernel` (scratch, grid and launch).

Beside the kernel is its plain version, :func:`fused_greedy_decode_plain`,
which steps the same loop in Python with PyTorch ops. The wrapper
:func:`fused_greedy_decode_packed` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``launch_count`` counts the kernel's launches, ``engine_launches`` the
same launches by path. While a profile records, each decode, the plain
version's too, adds :func:`decode_counts` to ``utils.profiling.COUNTERS``
once the card has run it, from the launch's tokens and ``fixstat`` copied
to the host when the counts are read: the recording launches no kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stroke_derenderer_tpu_torch.config import EOS, PAD
from stroke_derenderer_tpu_torch.models.decoder import (
    F32_WEIGHTS, STEP_WEIGHTS, decode_step, greedy_loop,
)
from stroke_derenderer_tpu_torch.utils.profiling import COUNTERS, recording

# Launches of the CUDA kernel since import (or since a caller reset it).
launch_count = 0
# Grid barriers per decode step.
BARRIERS_PER_STEP = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The path of phases A and D for each stream type (fixed when the kernel is
# built: csrc/decode_step.cuh's kMma): "mma" on the tensor cores, "f64" on
# CUDA cores in float64.
ENGINES = {torch.float32: "f64", torch.bfloat16: "mma"}
# Launches by path since import (never reset by the wrappers' callers).
engine_launches = {"f64": 0, "mma": 0}
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
    "preds", "score_out", "lens_out", "stamps",
    "mh", "m3map", "hmap", "hkind", "h16", "awe16", "fix", "fixstat",
    "astat")
STEP_DIMS = ("B", "P", "E", "A", "H", "D", "V", "K", "max_length",
             "NT", "KC", "R3", "RH")
# Pointers only one path reads (null for the other).
MMA_ONLY = ("mh", "m3map", "hmap", "hkind", "h16", "awe16", "fix", "fixstat")
F64_ONLY = ("h", "awe")

# The tensor-core path's constants, as in csrc/decode_step.cuh.
MMA_WARPS = 16     # WARPS
MMA_MAXJ = 1       # MAXJ: (m-tile, 8-row) jobs a warp holds
# FIXCAP, FIXWORDS: a block's list of elements to recompute in float64.
MMA_FIXCAP = MMA_WARPS * MMA_MAXJ * 128
MMA_FIXWORDS = 5
MMA_SPAD = 8       # SPAD: bf16 padding after every shared row
MMA_MAX_LT = 16    # MAX_LT: head m-tiles a block may own
# Shared memory a block may have on an H100 (and H200), and what is kept
# back for the kernels' static shared variables (about 3 KB on the
# tensor-core path: two lists of FIXS = 64 elements to recompute).
SMEM_PER_BLOCK = 232448
SMEM_STATIC_RESERVE = 4096
# Phases B and C (csrc/decode_step.cuh): rows of one image in a phase-C
# group at most (ATT_G), bytes of one row's cross-warp partial sums
# (ATT_RED) and a phase-C unit's fixed cost in 16ths of a pass (ATT_OV).
ATT_G = 8
ATT_RED = 4096
ATT_OV = 2
# (rows staged at a time, columns staged at a time), most preferred first:
# two buffers of rows x (columns + MMA_SPAD) bf16.
MMA_STAGING = ((128, 128), (128, 64), (64, 128), (64, 64), (64, 32),
               (32, 64), (32, 32), (32, 16), (16, 16), (8, 16))


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def split_bf16x3(x):
    """A float32 tensor as three bfloat16 tensors (hi, mid, lo) whose sum
    is ``x`` exactly: hi = x rounded to bfloat16, mid = the rest rounded,
    lo = what is left (8 significant bits at most, so exact for 2^-110 <=
    |x| <= 3.39e38, bfloat16's largest finite value). Each
    difference is exact in float32 (its operands lie within a factor of
    two of each other)."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def pack_step_weights(w: dict) -> dict:
    """``AttentiveDecoder.weights`` -> the layout the step engine reads
    (counterpart of the JAX ``pack_decoder_weights``). Every output column
    is stored with its K values contiguous, zero-padded to a multiple of 8:

    - ``m1`` (A + E, Hp): the columns of W_att, then those of W_f;
    - ``fc`` (V, Hp) float32: the columns of W_fc;
    - ``m3`` (4H, Xp + Hp): row 4j + g is gate g (i, f, g, o) of LSTM unit
      j: column gH + j of W_x (D + E values, padded to Xp), then the same
      column of W_h (H values, padded to Hp). A block owning unit j reads
      rows 4j to 4j + 3, one contiguous stretch;
    - for bfloat16 weights (the tensor-core path) also ``mh`` (A + E + 3V,
      Hp) bfloat16: the rows of ``m1``, then :func:`split_bf16x3` of
      ``fc``: its hi, mid and lo parts, W_fc column n at rows A + E + n,
      A + E + V + n and A + E + 2V + n.

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
    if m1.dtype == torch.bfloat16:
        packed["mh"] = torch.cat([packed["m1"], *split_bf16x3(packed["fc"])]
                                 ).contiguous()
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


def mma_slices(n_blocks: int, dims: dict) -> dict:
    """The tensor-core path's resident slices for the plan of
    :func:`step_plan` over ``n_blocks`` blocks (``dims`` as the launch's:
    A, E, V, H). Block b keeps in shared memory:

    - ``m3map[b]`` (R3 rows, R3 the most any block needs, rounded up to
      16): the rows 4j .. 4j + 3 of ``m3`` of its units j, in order, then
      -1 (zeros);
    - its head columns in m-tiles of 16: tile t holds columns c0 + 16t ..
      (rows of ``mh`` = the column's index; -1 past the block's last
      column), and where a tile holds any W_fc column, 16 rows of W_fc's
      mid parts and 16 of its lo parts after it (-1 at W_att and W_f
      columns). ``hkind[b][t]`` is 1 or 3 for those two shapes, 0 past
      the block's tiles; ``hmap[b]`` (RH rows) lists the rows.

    int32 numpy arrays, and the ints R3 and RH."""
    a, e, v, hdim = dims["A"], dims["E"], dims["V"], dims["H"]
    plan = step_plan(n_blocks, a, e, v, hdim)
    us, hs = plan["unit_start"], plan["head_start"]
    units = np.diff(us)
    r3 = max(16, _round16(4 * int(units.max())))
    m3map = np.full((n_blocks, r3), -1, np.int32)
    heads, kinds = [], []
    for b in range(n_blocks):
        m3map[b, :4 * units[b]] = 4 * us[b] + np.arange(4 * units[b])
        rows, kind = [], []
        cols = np.arange(hs[b], hs[b + 1])
        for t0 in range(0, len(cols), 16):
            tile = cols[t0:t0 + 16]
            fc = tile >= a + e
            rows.append(np.pad(tile, (0, 16 - len(tile)),
                               constant_values=-1))
            kind.append(3 if fc.any() else 1)
            if fc.any():
                for part in (v, 2 * v):  # mid, lo
                    rows.append(np.pad(np.where(fc, tile + part, -1),
                                       (0, 16 - len(tile)),
                                       constant_values=-1))
        heads.append(np.concatenate(rows) if rows else np.zeros(0, int))
        kinds.append(kind)
    if max(len(k) for k in kinds) > MMA_MAX_LT:
        raise ValueError(f"a block owns more than {MMA_MAX_LT} head m-tiles "
                         f"at {n_blocks} blocks")
    rh = max(len(r) for r in heads)
    hmap = np.full((n_blocks, rh), -1, np.int32)
    hkind = np.zeros((n_blocks, MMA_MAX_LT), np.int32)
    for b in range(n_blocks):
        hmap[b, :len(heads[b])] = heads[b]
        hkind[b, :len(kinds[b])] = kinds[b]
    return {"m3map": m3map, "hmap": hmap, "hkind": hkind, "R3": r3,
            "RH": rh}


def att_bytes(dims: dict) -> int:
    """Shared memory that phase C works in (``att_bytes`` in
    csrc/decode_step.cuh): the softmax weights of a group's rows
    (min(K, ATT_G) x P rounded up to 4, doubles) and one row of cross-warp
    partial sums at least."""
    pp = (dims["P"] + 3) // 4 * 4
    return 8 * min(dims["K"], ATT_G) * pp + ATT_RED


def att_tiling(ngroups: int, e: int, grid: int) -> dict:
    """Phase C's tiling of one step (``AttTiling`` in csrc/decode_step.cuh,
    which computes it on the card from the step's live rows): ``ngroups``
    groups of at most ATT_G rows of one image (an image's K2 beams; a K1
    row), E columns, ``grid`` blocks. A block's 16 warps take 32 cw columns
    (cw column chunks, 16 / cw warps of them per chunk over interleaved
    positions, two lane slices a warp, two columns a lane); cw = 16: a
    unit is a whole group, its columns in passes of 512; else a unit is
    one of the group's ``ntile`` tiles of 32 cw columns. The cw whose units end soonest, a unit costing its passes
    and ATT_OV in 16ths of a pass (ties to the wider); ``split``: a
    group's columns spread over several units."""
    nct = -(-e // 32)
    cw, ntile = MMA_WARPS, 1
    best = -(-ngroups // grid) * (MMA_WARPS * -(-nct // MMA_WARPS) + ATT_OV)
    c = MMA_WARPS // 2
    while c >= 1:
        nt = -(-nct // c)
        cost = -(-(ngroups * nt) // grid) * (c + ATT_OV)
        if cost < best:
            best, cw, ntile = cost, c, nt
        c //= 2
    return {"cw": cw, "ntile": ntile, "units": ngroups * ntile,
            "split": ntile > 1}


def mma_smem_bytes(dims: dict, r3: int, rh: int, nt: int, kc: int) -> int:
    """Dynamic shared memory of one tensor-core block (the layout of
    ``carve`` in csrc/decode_step.cuh): phase B's v (A doubles), the
    resident [W_x | W_h] and head slices (rows padded by MMA_SPAD), the
    staging region (two chunks of nt rows x kc columns, which after a
    tile's last chunk hold its split-k partial sums; phase C works there
    too, :func:`att_bytes`), the gate pre-activations, the block's maps,
    head m-tiles, plan entries and biases, and K2's picks."""
    xq, hq = _round16(dims["D"] + dims["E"]), _round16(dims["H"])
    stage = max(2 * 2 * nt * (kc + MMA_SPAD), att_bytes(dims))
    return (8 * dims["A"] + 2 * r3 * (xq + hq + MMA_SPAD)
            + 2 * rh * (hq + MMA_SPAD) + stage + 4 * nt * r3
            + 4 * (2 * MMA_MAX_LT + r3 + rh + 4) + 4 * (r3 + rh)
            + 4 * 5 * dims["K"])


def mma_plan(n_blocks: int, dims: dict) -> dict:
    """:func:`mma_slices` and the staging shape for one launch: the first
    (NT, KC) of ``MMA_STAGING`` whose shared memory fits a block and whose
    row tiles keep every warp at most MMA_MAXJ jobs. Raises if none fits."""
    sl = mma_slices(n_blocks, dims)
    nlog = max(sl["R3"] // 16, int((sl["hkind"] > 0).sum(1).max()))
    budget = SMEM_PER_BLOCK - SMEM_STATIC_RESERVE
    for nt, kc in MMA_STAGING:
        if nt > 8 * (MMA_WARPS * MMA_MAXJ // nlog):
            continue
        smem = mma_smem_bytes(dims, sl["R3"], sl["RH"], nt, kc)
        if smem <= budget:
            return sl | {"NT": nt, "KC": kc, "smem": smem}
    raise ValueError(f"the tensor-core path's slices do not fit in shared "
                     f"memory at {dims} over {n_blocks} blocks")


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
    for it uploaded to ``device`` (for the tensor-core path also
    :func:`mma_plan`'s maps and its NT, KC, R3 and RH); cached. Raises if
    the card cannot run the launch (no cooperative launch, or no block fits
    on an SM)."""
    key = (name, _DTYPE_CODE[dtype], str(device),
           *(dims[k] for k in STEP_DIMS[:9] if k not in ("B", "max_length")))
    if key not in _PLANS:
        _, _, grid_fn = _library(name)
        arr = (ctypes.c_int * len(STEP_DIMS))(*(dims.get(k, 0)
                                                for k in STEP_DIMS))
        grid = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = grid_fn(_DTYPE_CODE[dtype], ctypes.cast(arr, ctypes.c_void_p),
                         ctypes.byref(grid))
        if rc != 0:
            raise RuntimeError(f"{name}: the card cannot run the cooperative "
                               f"launch: CUDA error {rc}")
        plan = step_plan(grid.value, dims["A"], dims["E"], dims["V"],
                         dims["H"])
        if ENGINES[dtype] == "mma":
            mp = mma_plan(grid.value, dims)
            plan |= {k: mp[k] for k in ("m3map", "hmap", "hkind")}
        plan = {k: torch.from_numpy(t).to(device) for k, t in plan.items()}
        if ENGINES[dtype] == "mma":
            plan |= {k: mp[k] for k in ("NT", "KC", "R3", "RH")}
        _PLANS[key] = (grid.value, plan)
    return _PLANS[key]


def launch_step_kernel(name: str, enc, enc_proj, h0, c0, packed: dict,
                       k: int, max_length: int, outputs: dict) -> dict:
    """One cooperative launch of K1 (``name`` "fused_decode", k = 1) or K2
    ("fused_beam"): allocates the engine's scratch (h and the attended
    vector in float32 for the float64 path, in bfloat16 for the tensor-core
    path), fills the pointer array in ``STEP_POINTERS`` order (``outputs``
    gives preds and, for K2, score_out and lens_out; optionally ``stamps``,
    int64 of at least 3 + max_length x phases, for the phase clock, and, on
    the tensor-core path, ``fixstat``, int32 (grid, 2), for each block's
    count of elements recomputed in float64 and the largest error of the
    tensor-core sums among them as a share of their bound, a float32's bits;
    a pointer of the other path is null) and raises on a non-zero CUDA
    error code. Returns the launch's tensors by pointer name, its scratch
    included (such as ``fixstat``, K2's ``steps``, or ``astat``: the steps
    whose attended sum split a group's columns over blocks, and the steps
    run), for a caller that reads one once the launch has run."""
    b, p, e = enc.shape
    hdim = h0.shape[-1]
    v, d = packed["emb"].shape
    dims = {"B": b, "P": p, "E": e, "A": enc_proj.shape[-1], "H": hdim,
            "D": d, "V": v, "K": k, "max_length": max_length}
    dev = enc.device
    grid, plan = launch_grid(name, enc.dtype, dims, dev)
    dims |= {n: plan.get(n, 0) for n in STEP_DIMS[9:]}
    rows = b * k
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    hp = _round8(hdim)
    scratch = {"c": torch.empty((2, rows, hdim), **f32),
               "dp": torch.empty((rows, dims["A"]), **f32),
               "gate": torch.empty((rows, e), **f32),
               "sc": torch.empty((rows, (p + 3) // 4 * 4), **f32),
               "logits": torch.empty((rows, v), **f32),
               "rows": torch.empty((grid, 2 * rows), **i32),
               "astat": torch.empty(2, **i32)}
    if ENGINES[enc.dtype] == "mma":
        bf16 = dict(dtype=torch.bfloat16, device=dev)
        scratch |= {"h16": torch.empty((2, rows, hp), **bf16),
                    "awe16": torch.empty((rows, e), **bf16),
                    "fix": torch.empty((grid, MMA_FIXCAP * MMA_FIXWORDS),
                                       **i32),
                    "fixstat": torch.empty((grid, 2), **i32)}
    else:
        scratch |= {"h": torch.empty((2, rows, hp), **f32),
                    "awe": torch.empty((rows, e), **f32)}
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
    if ENGINES[enc.dtype] != "mma":
        tensors = {n: t for n, t in tensors.items() if n not in MMA_ONLY}
    elif "mh" not in packed:
        raise ValueError("bfloat16 streams need pack_step_weights of "
                         "bfloat16 weights (its mh)")
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
    return tensors


def greedy_steps(preds: torch.Tensor, max_length: int) -> torch.Tensor:
    """Steps each greedy row ran: through its first EOS, else all
    ``max_length``."""
    eos = preds == EOS
    return torch.where(eos.any(1), eos.int().argmax(1) + 1, max_length)


def greedy_counts(preds: torch.Tensor, max_length: int, head: int,
                  hdim: int, fixstat: torch.Tensor | None = None,
                  astat: torch.Tensor | None = None) -> dict:
    """:func:`decode_counts` of one greedy decode from its tokens, counted
    on the host: a kernel launched for the count, one the untraced path
    never loads, would block the host while K1 runs."""
    return decode_counts(greedy_steps(preds.cpu(), max_length), 1, head,
                         hdim, fixstat, astat)


def decode_counts(steps: torch.Tensor, k: int, head: int, hdim: int,
                  fixstat: torch.Tensor | None = None,
                  astat: torch.Tensor | None = None) -> dict:
    """The counters of one decode, from ``steps``, the steps each row (K1,
    k = 1) or each image's k beams (K2) ran:

    - ``decode_row_slots``: the steps the launch ran (it steps until no row
      is active, so the most any row needed) x its rows (images x k);
    - ``decode_row_steps``: the row-steps the rows needed;
    - on the tensor-core path (``fixstat``, (grid, 2) int32, given):
      ``decode_fixed_elements``, the elements recomputed in float64, and
      ``decode_fix_checked``, the elements whose rounding the bound decides
      (csrc/decode_step.cuh): the ``head`` = A + E dp and gate columns of
      every row in the prologue, then at every row-step the 4 x ``hdim``
      LSTM gates and the ``head`` columns again (the logits are not
      rounded there);
    - from a launch's ``astat`` (2 int32, given): ``decode_attend_steps``,
      the steps the launch ran, and ``decode_attend_split_steps``, those
      whose attended sum split a group's columns over blocks
      (:func:`att_tiling`)."""
    steps = steps.long().cpu()
    rows = steps.shape[0] * k
    need = k * int(steps.sum())
    out = {"decode_row_slots": int(steps.max()) * rows if rows else 0,
           "decode_row_steps": need}
    if fixstat is not None:
        out["decode_fixed_elements"] = int(fixstat.cpu()[:, 0].sum())
        out["decode_fix_checked"] = rows * head + need * (4 * hdim + head)
    if astat is not None:
        split, ran = (int(x) for x in astat.cpu())
        out["decode_attend_split_steps"] = split
        out["decode_attend_steps"] = ran
    return out


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
    head, hdim = enc_proj.shape[-1] + enc.shape[-1], h0.shape[-1]
    if enc.device.type == "cpu":
        preds = fused_greedy_decode_plain(enc, enc_proj, h0, c0, w,
                                          max_length)
        if recording():
            COUNTERS.defer(greedy_counts, preds, max_length, head, hdim)
        return preds
    if enc.device.type != "cuda":
        raise ValueError(f"no fused decode for device {enc.device}")
    _check(enc, enc_proj, h0, c0, w)
    preds = torch.full((enc.shape[0], max_length), PAD, dtype=torch.int32,
                       device=enc.device)
    if enc.shape[0] == 0 or max_length == 0:
        return preds
    launched = launch_step_kernel(
        "fused_decode", enc, enc_proj, h0, c0,
        pack_step_weights(w) if packed is None else packed, 1, max_length,
        {"preds": preds})
    launch_count += 1
    engine_launches[ENGINES[enc.dtype]] += 1
    if recording():
        COUNTERS.defer(greedy_counts, preds, max_length, head, hdim,
                       launched.get("fixstat"), launched["astat"])
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

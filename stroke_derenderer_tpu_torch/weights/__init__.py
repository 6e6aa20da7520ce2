"""Model weights: a reader and a writer for flax msgpack files,
``from_flax`` and ``to_flax`` for each network, random init, and model
directories.

A model directory holds flax parameter trees written by
``flax.serialization.to_bytes``: msgpack maps of str keys whose leaves are
msgpack ext type 1, itself the msgpack triple (shape, dtype name, raw C-order
bytes). :func:`read_msgpack` decodes that in pure Python, slicing the raw
bytes straight into numpy arrays, with no msgpack package;
:func:`write_msgpack` writes the same layout (keys sorted, as flax writes
them), so either package loads what the other wrote.

``from_flax_*`` turn such a tree (numpy leaves) into the ``state_dict`` of
the port's module, with the layout rules of the JAX package's
``weights/graph_export.py``: Conv HWIO -> OIHW, ConvTranspose flipped in
space and laid out (in, out, kh, kw), and the decoder's dense kernels kept
(in, out) with the LSTM's gates packed as ``kernels/fused_decode.py`` packs
them (``pack_decoder_weights``). They take a params tree or a whole flax
variables dict, whose ``batch_stats`` (the running ``mean`` and ``var`` of
each ``BatchNorm``) become the norm layers' running buffers. ``to_flax_*``
are their exact inverses for the params; ``*_variables`` give the whole
variables dict, ``batch_stats`` included where the model has batch norms.
The projection head (``strokes_projection.msgpack``) is a flax ``Dense``,
an ``nn.Linear`` here. A ViT glyph encoder has no JAX counterpart; its
``strokes_encoder.msgpack`` holds the flax layout that
:func:`from_flax_vit` reads (HF's Flax ViT: 2-D q, k and v kernels, so
that a kernel's fan-in is its first axis, and an ``out`` kernel (heads,
head_dim, hidden) that shows the head count). :func:`encoder_state` and
:func:`encoder_tree` read and write either kind by ``encoder_arch``.

:func:`init_binarizer`, :func:`init_strokes` and :func:`init_projection`
draw fresh parameters with flax's initializer families from a seeded
``torch.Generator``: truncated lecun-normal kernels, orthogonal LSTM hidden
kernels, zero biases, unit norm scales, zero running means and unit running
variances, and a normal(1/sqrt(D)) embedding (the numbers differ from the
JAX package's, the distributions do not).

The ONNX side, each a copy of the JAX package's module of the same name:
:mod:`.importer` (the protobuf wire-format tensor parser and the torch ->
flax layout converters), :mod:`.onnx_graph` (graph reader and writer),
:mod:`.graph_import` (the reference's ONNX model directory -> flax-layout
trees), :mod:`.graph_export` (a native model directory -> that layout) and
:mod:`.onnx_run` (a torch executor of the exported graphs, for the tests).
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path

import numpy as np
import torch

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
          0xca: ">f", 0xcb: ">d"}
_DTYPES = {"float32", "float64", "float16", "int8", "int16", "int32",
           "int64", "uint8", "uint16", "uint32", "uint64", "bool"}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.obj() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), "utf-8")
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _FIXED:
            return self.num(_FIXED[t])
        if t in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
            return self.take(self.num((">B", ">H", ">I")[t - 0xc4]))
        if t in (0xd9, 0xda, 0xdb):  # str 8/16/32
            return str(self.take(self.num((">B", ">H", ">I")[t - 0xd9])),
                       "utf-8")
        if t in (0xdc, 0xdd):  # array 16/32
            return [self.obj() for _ in range(self.num(">H" if t == 0xdc
                                                       else ">I"))]
        if t in (0xde, 0xdf):  # map 16/32
            return self.map(self.num(">H" if t == 0xde else ">I"))
        if t in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
            n = self.num((">B", ">H", ">I")[t - 0xc7])
            return self.ext(self.num(">b"), self.take(n))
        if 0xd4 <= t <= 0xd8:  # fixext 1..16
            code = self.num(">b")
            return self.ext(code, self.take(1 << (t - 0xd4)))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if k == "__msgpack_chunked_array__":
                raise ValueError("chunked msgpack arrays are not supported")
            out[k] = self.obj()
        return out

    @staticmethod
    def ext(code: int, data: memoryview):
        if code not in (1, 3):  # 1 = ndarray, 3 = numpy scalar
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, raw = _Reader(data).obj()
        name = name if isinstance(name, str) else str(name, "utf-8")
        if name not in _DTYPES:
            raise ValueError(f"unsupported array dtype {name!r}")
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == 3 else arr


def read_msgpack(path) -> dict:
    """flax msgpack file -> nested dict of numpy arrays (read-only views of
    one bytes object)."""
    buf = memoryview(Path(path).read_bytes())
    reader = _Reader(buf)
    tree = reader.obj()
    if reader.pos != len(buf):
        raise ValueError(f"{path}: {len(buf) - reader.pos} trailing bytes")
    return tree


def _params(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def _merged(tree: dict) -> dict:
    """A params tree, or a variables dict with its ``batch_stats`` merged
    into the params: each ``BatchNorm`` node then holds ``scale``,
    ``bias``, ``mean`` and ``var``."""
    def merge(p: dict, s: dict) -> dict:
        return {k: merge(v, s[k]) if isinstance(v, dict) and k in s
                else v for k, v in p.items()} | {
            k: v for k, v in s.items() if k not in p}
    if "params" not in tree:
        return tree
    return merge(tree["params"], tree.get("batch_stats", {}))


def flax_variables(tree: dict) -> dict:
    """The inverse of :func:`_merged`: a merged tree -> ``{"params": ...}``,
    with ``"batch_stats"`` (every ``mean`` and ``var`` leaf) where there
    are any."""
    def split(t: dict):
        params, stats = {}, {}
        for k, v in t.items():
            if isinstance(v, dict):
                params[k], s = split(v)
                if s:
                    stats[k] = s
            elif k in ("mean", "var"):
                stats[k] = v
            else:
                params[k] = v
        return params, stats
    params, stats = split(tree)
    return {"params": params} | ({"batch_stats": stats} if stats else {})


def _norm_name(q: dict, j: int) -> str | None:
    """The flax name of a block's j-th norm (GroupNorm_j or BatchNorm_j),
    None for a model without norms."""
    return next((f"{kind}_{j}" for kind in ("GroupNorm", "BatchNorm")
                 if f"{kind}_{j}" in q), None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _put_conv(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_norm(sd: dict, prefix: str, p: dict | None) -> None:
    if p is None:
        return
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    if "mean" in p:
        sd[f"{prefix}.running_mean"] = _t(p["mean"])
        sd[f"{prefix}.running_var"] = _t(p["var"])


def from_flax_unet(tree: dict, n_levels: int) -> dict:
    """AttentionUNet flax params or variables ->
    ``models.unet.AttentionUNet`` state."""
    p = _merged(tree)
    sd: dict = {}

    def block(prefix, q):
        for j in range(2):
            _put_conv(sd, f"{prefix}.conv{j}", q[f"Conv_{j}"])
            _put_norm(sd, f"{prefix}.norm{j}", q.get(_norm_name(q, j)))

    for i in range(n_levels):
        block(f"down.{i}", p[f"ConvBlock_{i}"])
    block("bottleneck", p[f"ConvBlock_{n_levels}"])
    for j in range(n_levels):
        up = p[f"ConvTranspose_{j}"]
        k = np.asarray(up["kernel"])[::-1, ::-1]
        sd[f"up.{j}.weight"] = _t(np.transpose(k, (2, 3, 0, 1)))
        sd[f"up.{j}.bias"] = _t(up["bias"])
        for name in ("gate_proj", "skip_proj", "psi"):
            _put_conv(sd, f"gates.{j}.{name}", p[f"AttentionGate_{j}"][name])
        block(f"up_blocks.{j}", p[f"ConvBlock_{n_levels + 1 + j}"])
    _put_conv(sd, "head", p["head"])
    return sd


def from_flax_encoder(tree: dict, kind: str) -> dict:
    """ResNetEncoder flax params or variables ->
    ``models.encoder.ResNetEncoder`` state."""
    p = _merged(tree)
    sd: dict = {}
    _put_conv(sd, "stem", p["stem"])
    _put_norm(sd, "stem_norm", p[_norm_name(p, 0)])
    n_convs = 2 if kind == "basic" else 3
    name = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    idx = 0
    while f"{name}_{idx}" in p:
        q = p[f"{name}_{idx}"]
        for j in range(n_convs):
            _put_conv(sd, f"blocks.{idx}.convs.{j}", q[f"Conv_{j}"])
            _put_norm(sd, f"blocks.{idx}.norms.{j}", q[_norm_name(q, j)])
        if "proj" in q:
            _put_conv(sd, f"blocks.{idx}.proj", q["proj"])
            _put_norm(sd, f"blocks.{idx}.proj_norm",
                      q[_norm_name(q, n_convs)])
        idx += 1
    return sd


def from_flax_vit(tree: dict) -> dict:
    """A ViT's flax-layout params -> ``models.vit.ViTEncoder`` state: the
    patch kernel (p, p, 3, hidden) HWIO, flattened in the patch's (row,
    column, channel) order; ``cls`` and ``pos`` ``embedding`` leaves; per
    ``Block_i`` the (in, out) ``query``, ``key`` and ``value`` kernels
    concatenated into one qkv GEMM, the ``out`` kernel (heads, head_dim,
    hidden) flattened head-major; ``LayerNorm_final``."""
    p = _params(tree)

    def dense(prefix, q):
        k = np.asarray(q["kernel"])
        sd[f"{prefix}.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
        sd[f"{prefix}.bias"] = _t(q["bias"])

    def norm(prefix, q):
        sd[f"{prefix}.weight"] = _t(q["scale"])
        sd[f"{prefix}.bias"] = _t(q["bias"])

    sd: dict = {}
    dense("patch", p["patch"])
    sd["cls"] = _t(p["cls"]["embedding"])
    sd["pos"] = _t(p["pos"]["embedding"])
    i = 0
    while f"Block_{i}" in p:
        q, pre = p[f"Block_{i}"], f"blocks.{i}"
        norm(f"{pre}.ln1", q["LayerNorm_0"])
        sd[f"{pre}.qkv.weight"] = _t(np.concatenate(
            [q[n]["kernel"] for n in ("query", "key", "value")], 1).T)
        sd[f"{pre}.qkv.bias"] = _t(np.concatenate(
            [q[n]["bias"] for n in ("query", "key", "value")]))
        dense(f"{pre}.out", q["out"])
        norm(f"{pre}.ln2", q["LayerNorm_1"])
        dense(f"{pre}.fc1", q["Dense_0"])
        dense(f"{pre}.fc2", q["Dense_1"])
        i += 1
    norm("norm", p["LayerNorm_final"])
    return sd


def from_flax_projection(tree: dict) -> dict:
    """The projection head's flax Dense params -> ``nn.Linear`` state."""
    p = _params(tree)
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def from_flax_decoder(tree: dict) -> dict:
    """AttentiveDecoder flax params -> ``models.decoder.AttentiveDecoder``
    state, in the fused kernel's layout."""
    p = _params(tree)
    lstm = p["lstm"]
    gates = ("i", "f", "g", "o")
    return {
        "emb": _t(p["embedding"]["embedding"]),
        "enc_att_w": _t(p["enc_att"]["kernel"]),
        "enc_att_b": _t(p["enc_att"]["bias"]),
        "watt": _t(p["dec_att"]["kernel"]), "batt": _t(p["dec_att"]["bias"]),
        "v": _t(np.asarray(p["full_att"]["kernel"])[:, 0]),
        "bv": _t(p["full_att"]["bias"]),
        "init_h_w": _t(p["init_h"]["kernel"]),
        "init_h_b": _t(p["init_h"]["bias"]),
        "init_c_w": _t(p["init_c"]["kernel"]),
        "init_c_b": _t(p["init_c"]["bias"]),
        "wf": _t(p["f_beta"]["kernel"]), "bf": _t(p["f_beta"]["bias"]),
        "wx": _t(np.concatenate([lstm[f"i{g}"]["kernel"] for g in gates], 1)),
        "wh": _t(np.concatenate([lstm[f"h{g}"]["kernel"] for g in gates], 1)),
        "blstm": _t(np.concatenate([lstm[f"h{g}"]["bias"] for g in gates])),
        "wfc": _t(p["fc"]["kernel"]), "bfc": _t(p["fc"]["bias"]),
    }


# --------------------------------------------------------------- writing

def _pack(obj, out: list) -> None:
    """Append the msgpack encoding of ``obj`` (dict with str keys, list or
    tuple, str, int, bytes, numpy array) to ``out``, each in its shortest
    form, as msgpack's packer chooses it."""
    if isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n <= 15 else
                   struct.pack(">BH", 0xde, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xdf, n))
        for k in sorted(obj):
            _pack(str(k), out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n <= 15 else
                   struct.pack(">BH", 0xdc, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xdd, n))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        out.append(bytes([0xa0 | n]) if n <= 31 else
                   struct.pack(">BB", 0xd9, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xda, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xdb, n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        out.append(struct.pack(">BB", 0xc4, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xc5, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xc6, n))
        out.append(bytes(obj))
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (int, np.integer)) and not isinstance(
            obj, np.ndarray):
        v = int(obj)
        if 0 <= v <= 0x7f or -32 <= v < 0:
            out.append(struct.pack(">b" if v < 0 else ">B", v))
        elif v >= 0:
            fmt = next((f for f, lim in ((">BB", 8), (">BH", 16),
                                          (">BI", 32), (">BQ", 64))
                        if v < 1 << lim))
            out.append(struct.pack(fmt, {">BB": 0xcc, ">BH": 0xcd,
                                         ">BI": 0xce, ">BQ": 0xcf}[fmt], v))
        else:
            fmt = next((f for f, lim in ((">Bb", 7), (">Bh", 15),
                                          (">Bi", 31), (">Bq", 63))
                        if v >= -(1 << lim)))
            out.append(struct.pack(fmt, {">Bb": 0xd0, ">Bh": 0xd1,
                                         ">Bi": 0xd2, ">Bq": 0xd3}[fmt], v))
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        arr = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
               else obj)
        inner: list = []
        _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), inner)
        data = b"".join(inner)
        n = len(data)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        out.append(struct.pack(">Bb", fixext[n], 1) if n in fixext else
                   struct.pack(">BBb", 0xc7, n, 1) if n < 1 << 8 else
                   struct.pack(">BHb", 0xc8, n, 1) if n < 1 << 16 else
                   struct.pack(">BIb", 0xc9, n, 1))
        out.append(data)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def msgpack_bytes(tree) -> bytes:
    """A nested dict of arrays -> the bytes ``flax.serialization.to_bytes``
    gives for it (arrays as ext type 1, keys sorted)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def write_msgpack(tree, path) -> None:
    Path(path).write_bytes(msgpack_bytes(tree))


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _hwio(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _get_conv(sd: dict, prefix: str) -> dict:
    p = {"kernel": _hwio(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _get_norm(sd: dict, prefix: str, q: dict, j: int) -> None:
    """Put the norm layer at ``prefix`` (if any) into ``q`` under its flax
    name, its running statistics beside its scale and bias."""
    if f"{prefix}.weight" not in sd:
        return
    p = {"scale": _np(sd[f"{prefix}.weight"]),
         "bias": _np(sd[f"{prefix}.bias"])}
    if f"{prefix}.running_mean" in sd:
        p |= {"mean": _np(sd[f"{prefix}.running_mean"]),
              "var": _np(sd[f"{prefix}.running_var"])}
    q[f"{'BatchNorm' if 'mean' in p else 'GroupNorm'}_{j}"] = p


def unet_variables(sd: dict, n_levels: int) -> dict:
    """``models.unet.AttentionUNet`` state -> flax variables (params, and
    batch_stats for batch norms); the inverse of :func:`from_flax_unet`."""
    p: dict = {}

    def block(prefix):
        q = {}
        for j in range(2):
            q[f"Conv_{j}"] = _get_conv(sd, f"{prefix}.conv{j}")
            _get_norm(sd, f"{prefix}.norm{j}", q, j)
        return q

    for i in range(n_levels):
        p[f"ConvBlock_{i}"] = block(f"down.{i}")
    p[f"ConvBlock_{n_levels}"] = block("bottleneck")
    for j in range(n_levels):
        k = np.transpose(_np(sd[f"up.{j}.weight"]), (2, 3, 0, 1))[::-1, ::-1]
        p[f"ConvTranspose_{j}"] = {"kernel": np.ascontiguousarray(k),
                                   "bias": _np(sd[f"up.{j}.bias"])}
        p[f"AttentionGate_{j}"] = {
            name: _get_conv(sd, f"gates.{j}.{name}")
            for name in ("gate_proj", "skip_proj", "psi")}
        p[f"ConvBlock_{n_levels + 1 + j}"] = block(f"up_blocks.{j}")
    p["head"] = _get_conv(sd, "head")
    return flax_variables(p)


def to_flax_unet(sd: dict, n_levels: int) -> dict:
    """``models.unet.AttentionUNet`` state -> flax params (the inverse of
    :func:`from_flax_unet`)."""
    return unet_variables(sd, n_levels)["params"]


def encoder_variables(sd: dict, kind: str) -> dict:
    """``models.encoder.ResNetEncoder`` state -> flax variables (params,
    and batch_stats for batch norms); the inverse of
    :func:`from_flax_encoder`."""
    p = {"stem": _get_conv(sd, "stem")}
    _get_norm(sd, "stem_norm", p, 0)
    n_convs = 2 if kind == "basic" else 3
    name = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    idx = 0
    while f"blocks.{idx}.convs.0.weight" in sd:
        q = {}
        for j in range(n_convs):
            q[f"Conv_{j}"] = _get_conv(sd, f"blocks.{idx}.convs.{j}")
            _get_norm(sd, f"blocks.{idx}.norms.{j}", q, j)
        if f"blocks.{idx}.proj.weight" in sd:
            q["proj"] = _get_conv(sd, f"blocks.{idx}.proj")
            _get_norm(sd, f"blocks.{idx}.proj_norm", q, n_convs)
        p[f"{name}_{idx}"] = q
        idx += 1
    return flax_variables(p)


def to_flax_encoder(sd: dict, kind: str) -> dict:
    """``models.encoder.ResNetEncoder`` state -> flax params (the inverse of
    :func:`from_flax_encoder`)."""
    return encoder_variables(sd, kind)["params"]


def vit_variables(sd: dict, heads: int) -> dict:
    """``models.vit.ViTEncoder`` state -> flax variables (params only);
    the inverse of :func:`from_flax_vit`. ``heads`` shapes the ``out``
    kernel (heads, head_dim, hidden), which the state does not record."""
    g = {k: _np(v) for k, v in sd.items()}

    def dense(prefix, shape=None):
        k = np.ascontiguousarray(g[f"{prefix}.weight"].T)
        return {"kernel": k if shape is None else k.reshape(shape),
                "bias": g[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": g[f"{prefix}.weight"], "bias": g[f"{prefix}.bias"]}

    hidden = g["cls"].shape[-1]
    patch = int(round((g["patch.weight"].shape[1] // 3) ** 0.5))
    p = {"patch": dense("patch", (patch, patch, 3, hidden)),
         "cls": {"embedding": g["cls"]}, "pos": {"embedding": g["pos"]},
         "LayerNorm_final": norm("norm")}
    i = 0
    while f"blocks.{i}.qkv.weight" in g:
        pre = f"blocks.{i}"
        qkv = dense(f"{pre}.qkv")
        block = {"LayerNorm_0": norm(f"{pre}.ln1"),
                 "out": dense(f"{pre}.out", (heads, hidden // heads, hidden)),
                 "LayerNorm_1": norm(f"{pre}.ln2"),
                 "Dense_0": dense(f"{pre}.fc1"),
                 "Dense_1": dense(f"{pre}.fc2")}
        for j, n in enumerate(("query", "key", "value")):
            cols = slice(j * hidden, (j + 1) * hidden)
            block[n] = {"kernel": np.ascontiguousarray(qkv["kernel"][:, cols]),
                        "bias": qkv["bias"][cols].copy()}
        p[f"Block_{i}"] = block
        i += 1
    return {"params": p}


def encoder_state(tree: dict, arch: str) -> dict:
    """The flax tree of the glyph encoder ``arch`` -> the state of
    ``models.encoder.make_encoder``'s module."""
    from stroke_derenderer_tpu_torch.models.encoder import encoder_kind
    kind = encoder_kind(arch)
    return from_flax_vit(tree) if kind == "vit" else \
        from_flax_encoder(tree, kind)


def encoder_tree(encoder) -> dict:
    """A glyph encoder module (``models.encoder.make_encoder``'s) -> its
    flax variables; the inverse of :func:`encoder_state`."""
    from stroke_derenderer_tpu_torch.models.vit import ViTEncoder
    if isinstance(encoder, ViTEncoder):
        return vit_variables(encoder.state_dict(), encoder.heads)
    return encoder_variables(encoder.state_dict(), encoder.kind)


def to_flax_projection(sd: dict) -> dict:
    """``nn.Linear`` state -> the projection head's flax Dense params."""
    return {"kernel": np.ascontiguousarray(_np(sd["weight"]).T),
            "bias": _np(sd["bias"])}


def to_flax_decoder(sd: dict) -> dict:
    """``models.decoder.AttentiveDecoder`` state -> flax params (the inverse
    of :func:`from_flax_decoder`: the packed LSTM gates split back)."""
    g = {k: _np(v) for k, v in sd.items()}
    hdim = g["wh"].shape[0]
    dense = lambda w, b: {"kernel": w, "bias": b}
    lstm = {}
    for n, gate in enumerate("ifgo"):
        cols = slice(n * hdim, (n + 1) * hdim)
        lstm[f"i{gate}"] = {"kernel": np.ascontiguousarray(g["wx"][:, cols])}
        lstm[f"h{gate}"] = dense(np.ascontiguousarray(g["wh"][:, cols]),
                                 g["blstm"][cols].copy())
    return {
        "embedding": {"embedding": g["emb"]},
        "enc_att": dense(g["enc_att_w"], g["enc_att_b"]),
        "dec_att": dense(g["watt"], g["batt"]),
        "full_att": dense(np.ascontiguousarray(g["v"][:, None]), g["bv"]),
        "init_h": dense(g["init_h_w"], g["init_h_b"]),
        "init_c": dense(g["init_c_w"], g["init_c_b"]),
        "f_beta": dense(g["wf"], g["bf"]),
        "lstm": lstm,
        "fc": dense(g["wfc"], g["bfc"]),
    }


# ------------------------------------------------------------ random init

def _init_tree(tree: dict, gen: torch.Generator, path: tuple = ()) -> dict:
    """Fresh values for a flax params tree of the right shapes, leaf by leaf
    in sorted key order, by flax's default initializer for each name:
    ``kernel`` truncated lecun normal (fan-in = all axes but the last), the
    LSTM's hidden kernels (``lstm/h*``) orthogonal, ``bias`` and the
    running ``mean`` zeros, ``scale`` and the running ``var`` ones,
    ``embedding`` normal with variance 1/D."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _init_tree(v, gen, path + (k,))
            continue
        shape = tuple(np.shape(v))
        t = torch.empty(shape)
        if k == "kernel" and len(path) >= 2 and path[-2] == "lstm" \
                and path[-1].startswith("h"):
            torch.nn.init.orthogonal_(t, generator=gen)
        elif k == "kernel":
            # lecun_normal: variance 1/fan_in, truncated at two standard
            # deviations and rescaled (jax.nn.initializers).
            std = math.sqrt(1.0 / math.prod(shape[:-1])) / .87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        elif k == "embedding":
            t.normal_(0.0, math.sqrt(1.0 / shape[-1]), generator=gen)
        elif k in ("scale", "var"):
            t.fill_(1.0)
        elif k in ("bias", "mean"):
            t.zero_()
        else:
            raise ValueError(f"no initializer for {'/'.join(path + (k,))}")
        out[k] = t.numpy()
    return out


def init_binarizer(config, seed: int = 0):
    """A freshly initialized ``models.unet.AttentionUNet`` (float32
    parameters on the CPU) for ``config`` (a ``BinarizerConfig``)."""
    from stroke_derenderer_tpu_torch.device import dtype_of
    from stroke_derenderer_tpu_torch.models.unet import AttentionUNet
    model = AttentionUNet(config.features, config.bottleneck, config.channels,
                          dtype=dtype_of(config.compute_dtype),
                          norm=config.norm, quant=config.quant)
    n = len(config.features)
    tree = _init_tree(_merged(unet_variables(model.state_dict(), n)),
                      torch.Generator().manual_seed(seed))
    model.load_state_dict(from_flax_unet(tree, n))
    return model


def init_strokes(config, seed: int = 0):
    """Freshly initialized (encoder, ``AttentiveDecoder``) (on the CPU;
    ResNet and decoder parameters float32, a ViT's in ``compute_dtype``)
    for ``config`` (a ``StrokesConfig``; the encoder
    ``models.encoder.make_encoder``'s); the encoder draws first, then the
    decoder, from one generator. The decoder reads ``projection_dim``
    features where there is a projection head (:func:`init_projection`)."""
    from stroke_derenderer_tpu_torch.device import dtype_of
    from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
    from stroke_derenderer_tpu_torch.models.encoder import make_encoder
    dtype = dtype_of(config.compute_dtype)
    encoder = make_encoder(config, dtype)
    decoder = AttentiveDecoder(config.vocab_size, config.embed_dim,
                               config.attention_dim, config.decoder_dim,
                               config.projection_dim or encoder.out_features,
                               dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    encoder.load_state_dict(encoder_state(_init_tree(_merged(
        encoder_tree(encoder)), gen), config.encoder_arch))
    decoder.load_state_dict(from_flax_decoder(
        _init_tree(to_flax_decoder(decoder.state_dict()), gen)))
    return encoder, decoder


def init_projection(config, seed: int = 0):
    """A freshly initialized projection head (``nn.Linear`` from the
    encoder's features to ``projection_dim``) for ``config``, from a
    generator of its own (seeded ``seed + 1``); None without a projection."""
    from stroke_derenderer_tpu_torch.models.encoder import encoder_width
    if not config.projection_dim:
        return None
    proj = torch.nn.Linear(encoder_width(config.encoder_arch),
                           config.projection_dim)
    proj.load_state_dict(from_flax_projection(_init_tree(
        to_flax_projection(proj.state_dict()),
        torch.Generator().manual_seed(seed + 1))))
    return proj


def _variables(tree: dict) -> dict:
    """A params tree or a variables dict -> a variables dict."""
    return tree if "params" in tree else {"params": tree}


def save_model_files(out_dir, bin_tree: dict | None = None, bin_config=None,
                     encoder_tree: dict | None = None,
                     decoder_tree: dict | None = None,
                     strokes_config=None,
                     projection_tree: dict | None = None) -> None:
    """Write a model directory's files from flax params trees or variables
    dicts, for whichever networks are given: ``binarizer.msgpack`` +
    ``configs_binarizer.json``, ``strokes_{encoder,decoder}.msgpack`` (+
    ``strokes_projection.msgpack``) + ``configs_strokes.json``. Each msgpack
    file holds the variables dict (``{"params": tree}``, with
    ``"batch_stats"`` for batch norms), as the JAX package's
    ``save_variables`` writes it."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if bin_tree is not None:
        write_msgpack(_variables(bin_tree), out / "binarizer.msgpack")
        (out / "configs_binarizer.json").write_text(
            json.dumps(bin_config.export_dict(), indent=1))
    if encoder_tree is not None:
        write_msgpack(_variables(encoder_tree),
                      out / "strokes_encoder.msgpack")
        write_msgpack(_variables(decoder_tree),
                      out / "strokes_decoder.msgpack")
        if projection_tree is not None:
            write_msgpack(_variables(projection_tree),
                          out / "strokes_projection.msgpack")
        (out / "configs_strokes.json").write_text(
            json.dumps(strokes_config.export_dict(), indent=1))


def materialize_model_dir(model_dir, bin_config=None, strokes_config=None,
                          seed: int = 0) -> None:
    """Write a complete randomly initialized model directory (the default
    configs unless given)."""
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    bin_config = bin_config or BinarizerConfig()
    strokes_config = strokes_config or StrokesConfig()
    encoder, decoder = init_strokes(strokes_config, seed)
    proj = init_projection(strokes_config, seed)
    save_model_files(
        model_dir, unet_variables(init_binarizer(bin_config, seed).state_dict(),
                                  len(bin_config.features)), bin_config,
        encoder_tree(encoder),
        to_flax_decoder(decoder.state_dict()), strokes_config,
        None if proj is None else to_flax_projection(proj.state_dict()))

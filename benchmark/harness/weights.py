"""Model directories for the cells: a configuration's committed directory
as it is, or one drawn at random, written as the flax msgpack files and
config JSONs a model directory holds, for the program to load through its
normal entry.

Random weights are drawn on the card from the configuration's own fixed
seed, in one call per kind of leaf: kernels N(0, 1 / fan_in), biases 0,
norm scales 1, and batch-norm running statistics off the identity (means
N(0.2, 0.3), variances U(0.5, 2)), so that no normalisation is a no-op.
A configuration's ``decoder_weights`` names a committed model directory
whose trained decoder takes the drawn one's place (the widths must match).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

import encoders
from harness.cell import ROOT
from reference import msgpack
from reference.models import merged


def _conv(k: int, cin: int, cout: int, bias: bool = True) -> dict:
    p = {"kernel": (k, k, cin, cout)}
    return p | ({"bias": (cout,)} if bias else {})


def _norm(kind: str, c: int) -> tuple[str, dict]:
    if kind == "batch":
        return "BatchNorm", {"scale": (c,), "bias": (c,), "mean": (c,), "var": (c,)}
    return "GroupNorm", {"scale": (c,), "bias": (c,)}


def unet_shapes(features, bottleneck: int, channels: int, norm: str) -> dict:
    def block(cin, f):
        q = {}
        for j, c in enumerate((cin, f)):
            q[f"Conv_{j}"] = _conv(3, c, f, bias=False)
            name, leaves = _norm(norm, f)
            q[f"{name}_{j}"] = leaves
        return q
    n = len(features)
    p, cin = {}, channels
    for i, f in enumerate(features):
        p[f"ConvBlock_{i}"] = block(cin, f)
        cin = f
    p[f"ConvBlock_{n}"] = block(cin, bottleneck)
    cin = bottleneck
    for j, f in enumerate(reversed(features)):
        inter = max(f // 2, 4)
        p[f"ConvTranspose_{j}"] = {"kernel": (2, 2, cin, f), "bias": (f,)}
        p[f"AttentionGate_{j}"] = {"gate_proj": _conv(1, f, inter),
                                   "skip_proj": _conv(1, f, inter),
                                   "psi": _conv(1, inter, 1)}
        p[f"ConvBlock_{n + 1 + j}"] = block(2 * f, f)
        cin = f
    p["head"] = _conv(1, features[0], 1)
    return p


def decoder_shapes(v: int, d: int, a: int, hdim: int, e: int) -> dict:
    def dense(i, o):
        return {"kernel": (i, o), "bias": (o,)}
    lstm = {}
    for g in "ifgo":
        lstm[f"i{g}"] = {"kernel": (d + e, hdim)}
        lstm[f"h{g}"] = dense(hdim, hdim)
    return {"embedding": {"embedding": (v, d)}, "enc_att": dense(e, a),
            "dec_att": dense(hdim, a), "full_att": dense(a, 1),
            "init_h": dense(e, hdim), "init_c": dense(e, hdim),
            "f_beta": dense(hdim, e), "lstm": lstm, "fc": dense(hdim, v)}


def _leaves(shapes: dict, path=()):
    for k, v in shapes.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def draw(shapes: dict, gen: torch.Generator, device) -> dict:
    """Random values for every leaf of ``shapes`` on ``device``, drawn in
    one call per kind of leaf -> the same nested dict of float32 tensors."""
    leaves = list(_leaves(shapes))
    kinds = {"kernel": [], "embedding": [], "mean": [], "var": []}
    for path, shape in leaves:
        if path[-1] in kinds:
            kinds[path[-1]].append((path, shape))
    values = {}
    for kind, items in kinds.items():
        sizes = [int(np.prod(s)) for _, s in items]
        if not sizes:
            continue
        if kind == "var":
            flat = torch.rand(sum(sizes), generator=gen, device=device) * 1.5 + 0.5
        else:
            flat = torch.randn(sum(sizes), generator=gen, device=device)
        for (path, shape), part in zip(items, flat.split(sizes)):
            if kind == "mean":
                part = part * 0.3 + 0.2
            elif kind == "kernel":
                part = part / float(np.prod(shape[:-1])) ** 0.5
            elif kind == "embedding":
                part = part / float(shape[1]) ** 0.5
            values[path] = part.view(shape)
    out: dict = {}
    for path, shape in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        fill = 1.0 if path[-1] == "scale" else 0.0
        node[path[-1]] = values.get(path, torch.full(shape, fill, device=device))
    return out


def _split_stats(tree: dict) -> dict:
    """A tree with running statistics beside the params -> a flax variables
    dict ({"params": ...} and, where there are any, {"batch_stats": ...})."""
    def split(t):
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


def _shapes(tree: dict) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else np.shape(v) for k, v in tree.items()}


def _numpy(tree: dict) -> dict:
    return {k: _numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


def random_model_dir(cfg: dict, out: Path, device) -> dict:
    """Draw the networks of configuration ``cfg`` from its ``weights_seed``
    on ``device``, write them into ``out`` as a model directory, and return
    the trees (numpy leaves, running statistics beside the params):
    {"binarizer", "encoder", "projection" or None, "decoder"}."""
    b, s = cfg["binarizer"], cfg["strokes"]
    gen = torch.Generator(device=device).manual_seed(int(cfg["weights_seed"]))
    encoder = encoders.family(s["encoder_arch"])
    width = encoder.width(s)
    enc_dim = s["projection_dim"] or width
    shapes = {
        "binarizer": unet_shapes(b["features"], b["bottleneck"], b["channels"], b["norm"]),
        "encoder": encoder.shapes(s),
        "projection": ({"kernel": (width, s["projection_dim"]), "bias": (s["projection_dim"],)}
                       if s["projection_dim"] else None),
        "decoder": decoder_shapes(3 + 2 * s["image_size"], s["embed_dim"],
                                  s["attention_dim"], s["decoder_dim"], enc_dim),
    }
    trees = {k: None if v is None else _numpy(draw(v, gen, device))
             for k, v in shapes.items()}
    out.mkdir(parents=True, exist_ok=True)
    files = {"binarizer": "binarizer.msgpack", "encoder": "strokes_encoder.msgpack",
             "projection": "strokes_projection.msgpack", "decoder": "strokes_decoder.msgpack"}
    # The drawn decoder is drawn all the same, so that the other networks'
    # leaves keep their values.
    if cfg.get("decoder_weights"):
        src = ROOT / cfg["decoder_weights"] / files["decoder"]
        trained = merged(msgpack.read(src))
        if _shapes(trained) != _shapes(trees["decoder"]):
            raise ValueError(f"{src}: the decoder's widths differ from the configuration's")
        trees["decoder"] = trained
        shutil.copyfile(src, out / files.pop("decoder"))
    for k, name in files.items():
        if trees[k] is not None:
            msgpack.write(_split_stats(trees[k]), out / name)
    (out / "configs_binarizer.json").write_text(json.dumps(b))
    (out / "configs_strokes.json").write_text(json.dumps(s))
    return trees


def read_model_dir(path: Path, cfg: dict) -> dict:
    """The trees of a committed model directory, read by the reference's
    own reader."""
    trees = {"binarizer": merged(msgpack.read(path / "binarizer.msgpack")),
             "encoder": merged(msgpack.read(path / "strokes_encoder.msgpack")),
             "decoder": merged(msgpack.read(path / "strokes_decoder.msgpack")),
             "projection": None}
    if cfg["strokes"]["projection_dim"]:
        trees["projection"] = merged(msgpack.read(path / "strokes_projection.msgpack"))
    return trees

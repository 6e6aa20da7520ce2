"""The ViT glyph encoder ``vit_l16``: ``google/vit-large-patch16-224``
(https://huggingface.co/google/vit-large-patch16-224, its ``config.json``;
arXiv:2010.11929, Table 1, "ViT-Large").

The crop cut into patch x patch squares, each patch's pixels in (row,
column, channel) order through a dense layer (the published conv of the
patch's size and stride); a learned CLS token before the patches and a
learned position embedding added to every token; per block (pre-LN)
LayerNorm, multi-head self-attention with q, k and v biases, residual,
LayerNorm, an MLP with exact (erf) GELU, residual; a final LayerNorm;
every LayerNorm eps 1e-12. The plain reference, in float32 with TF32 off:
materialized softmax attention, every matmul operand through
``reference.models._q``.

The leaves of ``strokes_encoder.msgpack`` (a kernel's last axis its
outputs, HF's Flax ViT layout): ``patch`` {kernel (p, p, 3, hidden),
bias}; ``cls`` and ``pos`` {embedding}; ``Block_i`` {``LayerNorm_0``,
``query``, ``key``, ``value`` {kernel (hidden, hidden), bias}, ``out``
{kernel (heads, head_dim, hidden), bias}, ``LayerNorm_1``, ``Dense_0``,
``Dense_1``}; ``LayerNorm_final``. q, k and v stay 2-D so that
``harness.weights.draw`` takes each kernel's fan-in as its first axis
(1/sqrt(hidden)); ``out`` keeps its heads visible, so that
:func:`forward`, which gets no configuration, reads the head count there.

Departures from the published model: the final LayerNorm's output for the
CLS token is dropped and the pooler and classifier head are left out (an
encoder hands on the patches' features, (N, 196, 1024) at 224 px); the
input is a crop normalized by the configuration's mean and std, as the
model's preprocessor normalizes with 0.5 and 0.5.
"""

from __future__ import annotations

import math

import torch

from reference import models

ARCHS = {  # arch -> (patch, hidden, depth, heads, MLP width)
    "vit_l16": (16, 1024, 24, 16, 4096),
    "vit_tiny": (16, 64, 2, 4, 256),     # the CPU tests' size
}
EPS = 1e-12


def _dense(i: int, o: int) -> dict:
    return {"kernel": (i, o), "bias": (o,)}


def _ln(hidden: int) -> dict:
    return {"scale": (hidden,), "bias": (hidden,)}


def shapes(s: dict) -> dict:
    patch, hidden, depth, heads, mlp = ARCHS[s["encoder_arch"]]
    p = {"patch": {"kernel": (patch, patch, 3, hidden), "bias": (hidden,)},
         "cls": {"embedding": (1, hidden)},
         "pos": {"embedding": (positions(s) + 1, hidden)},
         "LayerNorm_final": _ln(hidden)}
    for i in range(depth):
        p[f"Block_{i}"] = {"LayerNorm_0": _ln(hidden),
                           "query": _dense(hidden, hidden), "key": _dense(hidden, hidden),
                           "value": _dense(hidden, hidden),
                           "out": {"kernel": (heads, hidden // heads, hidden), "bias": (hidden,)},
                           "LayerNorm_1": _ln(hidden),
                           "Dense_0": _dense(hidden, mlp), "Dense_1": _dense(mlp, hidden)}
    return p


def _linear(x, p):
    k = p["kernel"]
    return models._q(x) @ models._q(k.reshape(-1, k.shape[-1]), True) + p["bias"]


def _layer_norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]


def forward(p: dict, images: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) normalized crops -> (N, (S / patch)**2, hidden) float32
    features, the patches in row-major order."""
    models.setup()
    heads, head_dim, hidden = p["Block_0"]["out"]["kernel"].shape
    ps = p["patch"]["kernel"].shape[0]
    n, size = images.shape[:2]
    g = size // ps
    x = images.reshape(n, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, -1)
    x = torch.cat([p["cls"]["embedding"].expand(n, 1, hidden), _linear(x, p["patch"])], 1)
    x = x + p["pos"]["embedding"]
    t = x.shape[1]
    i = 0
    while f"Block_{i}" in p:
        b = p[f"Block_{i}"]
        y = _layer_norm(x, b["LayerNorm_0"])
        q, k, v = (_linear(y, b[name]).reshape(n, t, heads, head_dim).transpose(1, 2)
                   for name in ("query", "key", "value"))
        w = torch.softmax(models._q(q) @ models._q(k).transpose(2, 3) / math.sqrt(head_dim), -1)
        o = (models._q(w) @ models._q(v)).transpose(1, 2).reshape(n, t, hidden)
        x = x + _linear(o, b["out"])
        h = _linear(_layer_norm(x, b["LayerNorm_1"]), b["Dense_0"])
        x = x + _linear(0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))), b["Dense_1"])
        i += 1
    return _layer_norm(x[:, 1:], p["LayerNorm_final"])


def width(s: dict) -> int:
    return ARCHS[s["encoder_arch"]][1]


def positions(s: dict) -> int:
    return (s["image_size"] // ARCHS[s["encoder_arch"]][0]) ** 2


def flops(s: dict) -> int:
    """One (image_size, image_size, 3) crop: the patch embedding, and per
    block the q, k, v and out GEMMs, the MLP's two and both attention
    products (scores and the attended sum) over the CLS token and the
    patches. LayerNorms, softmax and GELU are no operations."""
    patch, hidden, depth, heads, mlp = ARCHS[s["encoder_arch"]]
    p = positions(s)
    t = p + 1
    block = 2 * t * hidden * (4 * hidden + 2 * mlp) + 2 * 2 * t * t * hidden
    return 2 * p * patch * patch * 3 * hidden + depth * block

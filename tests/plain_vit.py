"""The plain reference of the ViT glyph encoder that the port's
``models/vit.py`` is held to: ``google/vit-large-patch16-224``'s forward
(arXiv:2010.11929, "ViT-Large"; HF's ``ViTModel`` without its pooler) in
float32, written straight from the flax-layout tree, with no kernel, no
fused GEMM and no ``scaled_dot_product_attention``. It imports nothing of
the port and nothing of JAX.

The tree (a kernel's last axis its outputs): ``patch`` {kernel (p, p, 3,
hidden), bias}; ``cls`` and ``pos`` {embedding (1 or tokens, hidden)};
``Block_i`` {``LayerNorm_0``, ``query``, ``key``, ``value`` {kernel
(hidden, hidden), bias}, ``out`` {kernel (heads, head_dim, hidden), bias},
``LayerNorm_1``, ``Dense_0``, ``Dense_1``}; ``LayerNorm_final``. The head
count and the patch size are read from the shapes.

Departures from the published model: the final LayerNorm's output for the
CLS token is dropped, and the pooler and the classifier head that follow
it are left out (an encoder hands on the patches' features only); the
input is a crop already normalized by the configuration's mean and std.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def _same(x):
    return x


def _dense(x, p, act):
    k = p["kernel"]
    return act(x) @ k.reshape(-1, k.shape[-1]) + p["bias"]


def _layer_norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def forward(tree: dict, images: torch.Tensor, act=None) -> torch.Tensor:
    """(N, S, S, 3) normalized crops -> (N, (S / p)**2, hidden) float32,
    the patches in row-major order. ``act``, where given, rounds every
    activation operand of a matrix product (the patches, the normalized
    tokens, q, k, the attention weights, v, the attended tokens, the MLP's
    hidden layer): a lower precision to hold a tolerance against."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    act = act or _same
    heads, head_dim, hidden = tree["Block_0"]["out"]["kernel"].shape
    p = tree["patch"]["kernel"].shape[0]
    n, s = images.shape[:2]
    g = s // p
    x = images.float().reshape(n, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = _dense(x.reshape(n, g * g, p * p * 3), tree["patch"], act)
    x = torch.cat([tree["cls"]["embedding"].expand(n, 1, hidden), x], 1)
    x = x + tree["pos"]["embedding"]
    t = x.shape[1]
    i = 0
    while f"Block_{i}" in tree:
        b = tree[f"Block_{i}"]
        y = _layer_norm(x, b["LayerNorm_0"])
        q, k, v = (_dense(y, b[name], act).reshape(n, t, heads, head_dim)
                   .transpose(1, 2) for name in ("query", "key", "value"))
        w = torch.softmax(act(q) @ act(k).transpose(2, 3)
                          / math.sqrt(head_dim), dim=-1)
        o = (act(w) @ act(v)).transpose(1, 2).reshape(n, t, hidden)
        x = x + _dense(o, b["out"], act)
        y = _layer_norm(x, b["LayerNorm_1"])
        x = x + _dense(_gelu(_dense(y, b["Dense_0"], act)), b["Dense_1"], act)
        i += 1
    return _layer_norm(x[:, 1:], tree["LayerNorm_final"])

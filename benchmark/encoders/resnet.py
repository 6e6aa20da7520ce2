"""The ResNet glyph encoders, ``resnet18`` and ``resnet50``.

7x7/2 stem, norm, ReLU, 3x3/2 max-pool, basic or bottleneck blocks (the
stride on the first block of each later stage, a 1x1 projection where the
shape changes), GroupNorm in groups of min(8, C) or BatchNorm on its
running statistics (``encoder_norm``); the 7x7 map repeated to 14x14 and
flattened row-major.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from counts import conv
from harness import weights
from reference import models

ARCHS = {  # arch -> (block kind, blocks per stage, stem width, expansion)
    "resnet18": ("basic", (2, 2, 2, 2), 64, 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 64, 4),
}


def shapes(s: dict) -> dict:
    kind, stages, stem, mult = ARCHS[s["encoder_arch"]]
    norm = s["encoder_norm"]
    name, leaves = weights._norm(norm, stem)
    p = {"stem": weights._conv(7, 3, stem, bias=False), f"{name}_0": leaves}
    cin, idx = stem, 0
    block = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    for i, blocks in enumerate(stages):
        f = stem << i
        for b in range(blocks):
            stride = 2 if b == 0 and i > 0 else 1
            if kind == "basic":
                convs = [(3, cin, f), (3, f, f)]
            else:
                convs = [(1, cin, f), (3, f, f), (1, f, f * mult)]
            q = {}
            for j, (k, ci, co) in enumerate(convs):
                q[f"Conv_{j}"] = weights._conv(k, ci, co, bias=False)
                nm, lv = weights._norm(norm, co)
                q[f"{nm}_{j}"] = lv
            cout = convs[-1][2]
            if cin != cout or stride != 1:
                q["proj"] = weights._conv(1, cin, cout, bias=False)
                nm, lv = weights._norm(norm, cout)
                q[f"{nm}_{len(convs)}"] = lv
            p[f"{block}_{idx}"] = q
            cin, idx = cout, idx + 1
    return p


def forward(p: dict, images: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) normalized crops -> (N, 196, C) float32 features."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(models._norm(models._conv(x, p["stem"], 2, 3), p, 0, 8))
    x = F.max_pool2d(x, 3, 2, 1)
    bottleneck = "BottleneckBlock_0" in p
    name = "BottleneckBlock" if bottleneck else "BasicBlock"
    i = 0
    while f"{name}_{i}" in p:
        q = p[f"{name}_{i}"]
        n = 3 if bottleneck else 2
        stride = _stride(p, name, i)
        if bottleneck:
            y = F.relu(models._norm(models._conv(x, q["Conv_0"]), q, 0, 8))
            y = F.relu(models._norm(models._conv(y, q["Conv_1"], stride, 1), q, 1, 8))
            y = models._norm(models._conv(y, q["Conv_2"]), q, 2, 8)
        else:
            y = F.relu(models._norm(models._conv(x, q["Conv_0"], stride, 1), q, 0, 8))
            y = models._norm(models._conv(y, q["Conv_1"], 1, 1), q, 1, 8)
        res = x if "proj" not in q else models._norm(models._conv(x, q["proj"], stride), q, n, 8)
        x = F.relu(y + res)
        i += 1
    x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def _stride(p: dict, name: str, i: int) -> int:
    """2 on the first block of every stage after the first: the blocks
    whose first 3x3 conv widens the channels (their width doubles)."""
    if i == 0:
        return 1
    conv = "Conv_1" if name == "BottleneckBlock" else "Conv_0"
    prev = p[f"{name}_{i - 1}"][conv]["kernel"].shape[-1]
    return 2 if p[f"{name}_{i}"][conv]["kernel"].shape[-1] > prev else 1


def width(s: dict) -> int:
    _, _, stem, mult = ARCHS[s["encoder_arch"]]
    return stem * 8 * mult


def positions(s: dict) -> int:
    return s["encode_image_size"] ** 2


def flops(s: dict) -> int:
    """One (image_size, image_size, 3) crop through the encoder; the
    repeat to 14x14 is no operation."""
    kind, stages, stem, mult = ARCHS[s["encoder_arch"]]
    hw = s["image_size"] // 2
    total = conv(1, 3, stem, 7, hw, hw)
    hw = (hw + 1) // 2          # 3x3 / 2 max-pool, pad 1
    cin = stem
    for i, blocks in enumerate(stages):
        f = stem << i
        for b in range(blocks):
            stride = 2 if b == 0 and i > 0 else 1
            out_hw = hw // stride
            if kind == "basic":
                total += conv(1, cin, f, 3, out_hw, out_hw) + conv(1, f, f, 3, out_hw, out_hw)
                cout = f
            else:
                total += (conv(1, cin, f, 1, hw, hw) + conv(1, f, f, 3, out_hw, out_hw)
                          + conv(1, f, f * mult, 1, out_hw, out_hw))
                cout = f * mult
            if cin != cout or stride != 1:
                total += conv(1, cin, cout, 1, out_hw, out_hw)
            cin, hw = cout, out_hw
    return total

"""ResNet glyph encoder, counterpart of the JAX ``models/encoder.py``.

(B, 224, 224, 3) normalized float, NHWC -> (B, 7, 7, C) float32, NHWC.
The traps of the reference: convolution pads are explicit (1, 1), not
SAME; GroupNorm has group size 8 and eps 1e-6; the stem max-pool is 3x3,
stride 2, pad 1; the 196-position sequence of :func:`encode_postprocess`
flattens in NHWC row-major order. ``norm`` is ``"group"`` (as shipped) or
``"batch"`` (running statistics, as an imported torch ResNet carries
them). ``quant="int8"`` contracts every convolution (the stem, the blocks'
convolutions and their ``proj``) in int8, as the JAX package does; the
parameters are the same in either mode.

The glyph encoders by ``encoder_arch``: the ResNets of :data:`ARCHS` and
the ViTs of ``models.vit.ARCHS``. :func:`make_encoder` builds either from
a ``StrokesConfig``, and :func:`encoder_kind` and :func:`encoder_width`
read the tables. A ViT's output is already the decoder's sequence; a
ResNet's map becomes it through :func:`encode_postprocess`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stroke_derenderer_tpu_torch.models import vit
from stroke_derenderer_tpu_torch.models.layers import (
    conv, make_norm, normalize,
)

# arch -> (block kind, stage sizes, stem width, channel multiplier)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 64, 1),
    "resnet34": ("basic", (3, 4, 6, 3), 64, 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 64, 4),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 64, 4),
    "tiny": ("basic", (1, 1, 1, 1), 8, 1),
}


def _norm(kind: str, channels: int) -> nn.Module:
    if kind not in ("group", "batch"):
        raise ValueError(f"encoder norm must be 'group' or 'batch', got "
                         f"{kind!r}")
    return make_norm(kind, channels, 8)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int,
                 norm: str = "group", quant: str = "none"):
        super().__init__()
        self.stride = stride
        self.quant = quant
        self.convs = nn.ModuleList([
            nn.Conv2d(cin, features, 3, stride, 1, bias=False),
            nn.Conv2d(features, features, 3, 1, 1, bias=False)])
        self.norms = nn.ModuleList([_norm(norm, features),
                                    _norm(norm, features)])
        self.proj = self.proj_norm = None
        if cin != features or stride != 1:
            self.proj = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.proj_norm = _norm(norm, features)

    def forward(self, x):
        q = self.quant
        y = F.relu(normalize(conv(x, self.convs[0], self.stride, 1, quant=q),
                             self.norms[0]))
        y = normalize(conv(y, self.convs[1], 1, 1, quant=q), self.norms[1])
        res = x if self.proj is None else normalize(
            conv(x, self.proj, self.stride, quant=q), self.proj_norm)
        return F.relu(y + res)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int,
                 norm: str = "group", quant: str = "none"):
        super().__init__()
        self.stride = stride
        self.quant = quant
        out = features * 4
        self.convs = nn.ModuleList([
            nn.Conv2d(cin, features, 1, bias=False),
            nn.Conv2d(features, features, 3, stride, 1, bias=False),
            nn.Conv2d(features, out, 1, bias=False)])
        self.norms = nn.ModuleList([_norm(norm, features),
                                    _norm(norm, features), _norm(norm, out)])
        self.proj = self.proj_norm = None
        if cin != out or stride != 1:
            self.proj = nn.Conv2d(cin, out, 1, stride, bias=False)
            self.proj_norm = _norm(norm, out)

    def forward(self, x):
        q = self.quant
        y = F.relu(normalize(conv(x, self.convs[0], quant=q), self.norms[0]))
        y = F.relu(normalize(conv(y, self.convs[1], self.stride, 1, quant=q),
                             self.norms[1]))
        y = normalize(conv(y, self.convs[2], quant=q), self.norms[2])
        res = x if self.proj is None else normalize(
            conv(x, self.proj, self.stride, quant=q), self.proj_norm)
        return F.relu(y + res)


class ResNetEncoder(nn.Module):
    def __init__(self, arch: str = "resnet50",
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group",
                 quant: str = "none"):
        super().__init__()
        kind, stages, stem, mult = ARCHS[arch]
        self.kind = kind
        self.dtype = dtype
        self.quant = quant
        self.out_features = stem * 8 * mult
        block = BasicBlock if kind == "basic" else BottleneckBlock
        self.stem = nn.Conv2d(3, stem, 7, 2, 3, bias=False)
        self.stem_norm = _norm(norm, stem)
        blocks, cin = [], stem
        for i, n_blocks in enumerate(stages):
            features = stem * 2 ** i
            for b in range(n_blocks):
                blocks.append(block(cin, features, 2 if b == 0 and i > 0
                                    else 1, norm, quant))
                cin = features * mult
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        # Contiguous NCHW, as in the UNet: GroupNorm on a channels-last
        # tensor splits its sums by the batch size on the CPU.
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        x = F.relu(normalize(conv(x, self.stem, 2, 3, quant=self.quant),
                             self.stem_norm))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return x.float().permute(0, 2, 3, 1)


def encoder_kind(arch: str) -> str:
    """``"basic"`` or ``"bottleneck"`` (a ResNet's blocks) or ``"vit"``."""
    if arch in ARCHS:
        return ARCHS[arch][0]
    if arch in vit.ARCHS:
        return "vit"
    raise ValueError(f"unknown encoder_arch {arch!r}: the ResNets are "
                     f"{sorted(ARCHS)}, the ViTs {sorted(vit.ARCHS)}")


def encoder_width(arch: str) -> int:
    """The feature width C of ``arch``'s sequence."""
    if encoder_kind(arch) == "vit":
        return vit.ARCHS[arch][1]
    _, _, stem, mult = ARCHS[arch]
    return stem * 8 * mult


def make_encoder(config, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The glyph encoder of a ``StrokesConfig``'s ``encoder_arch`` in
    ``dtype``, with its ``out_features``. A ViT cuts the crop into
    patches, so ``encode_image_size`` must be ``image_size // patch``, and
    it has no int8 path: either mismatch raises a ``ValueError``."""
    arch = config.encoder_arch
    if encoder_kind(arch) != "vit":
        return ResNetEncoder(arch, dtype=dtype, norm=config.encoder_norm,
                             quant=config.quant)
    patch = vit.ARCHS[arch][0]
    if config.quant != "none":
        raise ValueError(f"encoder_arch {arch!r} is a ViT, which has no "
                         f"{config.quant} path: its GEMMs run in "
                         "compute_dtype")
    if config.image_size % patch or \
            config.encode_image_size != config.image_size // patch:
        raise ValueError(
            f"encoder_arch {arch!r} cuts a {config.image_size}-px crop into "
            f"{patch}-px patches, so encode_image_size must be "
            f"{config.image_size // patch} (and image_size a multiple of "
            f"{patch}), got {config.encode_image_size}")
    return vit.ViTEncoder(arch, config.image_size, dtype=dtype)


def encode_postprocess(enc_map: torch.Tensor,
                       enc_image_size: int = 14) -> torch.Tensor:
    """(B, 7, 7, C) -> (B, enc_image_size**2, C) by 2x nearest duplication,
    flattened row-major over the NHWC grid."""
    b, h, _, c = enc_map.shape
    rep = enc_image_size // h
    x = enc_map.repeat_interleave(rep, dim=1).repeat_interleave(rep, dim=2)
    return x.reshape(b, enc_image_size * enc_image_size, c)

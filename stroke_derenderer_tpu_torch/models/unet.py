"""Attention U-Net (the binarizer), counterpart of the JAX ``models/unet.py``.

NHWC float in [0, 1] -> NHWC float32 foreground probabilities. Parameters
are float32; the convolutions run in ``dtype`` (bfloat16 as shipped) and
round where flax rounds (see :mod:`.layers`). The traps of the reference:
GroupNorm eps is 1e-6 and its group size is ``min(16, features)``; the
skip concat order is ``[gated, x]``; the head and its sigmoid run in
float32. ``norm`` is ``"group"`` (as shipped), ``"batch"`` (running
statistics, as an imported torch attention-UNet carries them) or
``"none"``. ``quant="int8"`` contracts the convolutions that the JAX
package quantizes in int8: both 3x3 convolutions of every ``ConvBlock``
and the gates' ``gate_proj`` and ``skip_proj``; ``psi``, the transposed
convolutions and the head stay float. The parameters are the same in
either mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stroke_derenderer_tpu_torch.models.layers import (
    conv, make_norm, normalize,
)


class ConvBlock(nn.Module):
    """Two (3x3 conv, norm, ReLU) stages."""

    def __init__(self, cin: int, features: int, norm: str = "group",
                 quant: str = "none"):
        super().__init__()
        self.quant = quant
        self.conv0 = nn.Conv2d(cin, features, 3, padding=1, bias=False)
        self.norm0 = make_norm(norm, features, 16)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm1 = make_norm(norm, features, 16)

    def forward(self, x):
        x = F.relu(normalize(conv(x, self.conv0, padding=1,
                                  quant=self.quant), self.norm0))
        return F.relu(normalize(conv(x, self.conv1, padding=1,
                                     quant=self.quant), self.norm1))


class AttentionGate(nn.Module):
    """x * sigmoid(psi(relu(Wg g + Wx x)))."""

    def __init__(self, g_ch: int, x_ch: int, inter: int,
                 quant: str = "none"):
        super().__init__()
        self.quant = quant
        self.gate_proj = nn.Conv2d(g_ch, inter, 1)
        self.skip_proj = nn.Conv2d(x_ch, inter, 1)
        self.psi = nn.Conv2d(inter, 1, 1)

    def forward(self, g, x):
        a = F.relu(conv(g, self.gate_proj, quant=self.quant)
                   + conv(x, self.skip_proj, quant=self.quant))
        # psi stays float: its sigmoid gates the skip path.
        return x * torch.sigmoid(conv(a, self.psi))


class AttentionUNet(nn.Module):
    """(B, H, W, C) float in [0, 1] -> (B, H, W, 1) float32 probabilities."""

    def __init__(self, features: Sequence[int] = (32, 64, 128, 256),
                 bottleneck: int = 512, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "group",
                 quant: str = "none"):
        super().__init__()
        self.dtype = dtype
        features = tuple(features)
        chans = (in_channels,) + features
        self.down = nn.ModuleList(ConvBlock(chans[i], f, norm, quant)
                                  for i, f in enumerate(features))
        self.bottleneck = ConvBlock(features[-1], bottleneck, norm, quant)
        ups, gates, blocks = [], [], []
        cin = bottleneck
        for f in reversed(features):
            ups.append(nn.ConvTranspose2d(cin, f, 2, stride=2))
            gates.append(AttentionGate(f, f, max(f // 2, 4), quant))
            blocks.append(ConvBlock(2 * f, f, norm, quant))
            cin = f
        self.up = nn.ModuleList(ups)
        self.gates = nn.ModuleList(gates)
        self.up_blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(features[0], 1, 1)

    def forward(self, x):
        # Contiguous NCHW: GroupNorm on a channels-last tensor splits its
        # sums by the batch size on the CPU, so a tile's mask would depend
        # on the batch it rides in.
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for up, gate, block, skip in zip(self.up, self.gates, self.up_blocks,
                                         reversed(skips)):
            x = conv(x, up, transposed=True, stride=2)
            x = block(torch.cat([gate(x, skip), x], dim=1))
        logits = conv(x.float(), self.head)
        return torch.sigmoid(logits).permute(0, 2, 3, 1)

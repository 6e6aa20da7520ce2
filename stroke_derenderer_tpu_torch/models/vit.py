"""ViT glyph encoder: a pre-LN vision transformer over square patches, as
``google/vit-large-patch16-224`` builds it (arXiv:2010.11929, Table 1,
"ViT-Large"; the model's ``config.json``).

(B, S, S, 3) normalized float, NHWC -> (B, (S / patch)**2, hidden)
float32: the patches' features in row-major order over the patch grid,
the CLS token dropped, the layout that ``encoder.encode_postprocess``
gives a ResNet's map. In order: the patch embedding (each patch's pixels
in (row, column, channel) order through one dense layer, which is the
published patch-sized, patch-strided convolution), a learned CLS token
before the patches and a learned position embedding added to every
token; ``depth`` pre-LN blocks (LayerNorm, multi-head self-attention
with q, k and v biases, residual; LayerNorm, an MLP with exact (erf)
GELU, residual); a final LayerNorm. Every LayerNorm has eps 1e-12.

The parameters are held in the module's dtype, bf16 on the card, so
that the GEMMs read them as they are: the patch embedding, q, k and v
fused into one GEMM (``from_flax_vit`` concatenates the three kernels),
the attention's output and the MLP are ``nn.Linear`` layers on cuBLAS,
the attention is ``F.scaled_dot_product_attention``, and the residual
stream is in the same dtype (``F.layer_norm`` takes its statistics in
float32). The attention may use any of PyTorch's backends but cuDNN's:
cuDNN builds an execution graph for each new batch size, and the glyph
count, so the batch, changes with every call; on an H100 that held the
card idle 65-95 ms at each new size of ViT-L/16's batch, where the flash
and memory-efficient kernels start at once and take 3-6% more card time
than cuDNN's at a size it has seen. The published model's pooler and
classifier head follow the final LayerNorm and are not part of an
encoder; they are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

EPS = 1e-12
ATTENTION = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.MATH]

# arch -> (patch, hidden, depth, heads, MLP width)
ARCHS = {
    "vit_l16": (16, 1024, 24, 16, 4096),
    "vit_tiny": (16, 64, 2, 4, 256),     # the CPU tests' size
}


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int, dtype):
        super().__init__()
        self.heads = heads
        self.ln1 = nn.LayerNorm(hidden, eps=EPS, dtype=dtype)
        self.qkv = nn.Linear(hidden, 3 * hidden, dtype=dtype)
        self.out = nn.Linear(hidden, hidden, dtype=dtype)
        self.ln2 = nn.LayerNorm(hidden, eps=EPS, dtype=dtype)
        self.fc1 = nn.Linear(hidden, mlp, dtype=dtype)
        self.fc2 = nn.Linear(mlp, hidden, dtype=dtype)

    def forward(self, x):
        b, t, h = x.shape
        q, k, v = self.qkv(self.ln1(x)).view(b, t, 3, self.heads, -1) \
            .permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v)
        x = x + self.out(a.transpose(1, 2).reshape(b, t, h))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class ViTEncoder(nn.Module):
    def __init__(self, arch: str = "vit_l16", image_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        patch, hidden, depth, heads, mlp = ARCHS[arch]
        self.dtype = dtype
        self.patch_size = patch
        self.grid = image_size // patch
        self.heads = heads
        self.out_features = hidden
        self.positions = self.grid ** 2
        self.tokens = self.positions + 1      # the CLS token and the patches
        self.patch = nn.Linear(patch * patch * 3, hidden, dtype=dtype)
        self.cls = nn.Parameter(torch.zeros(1, hidden, dtype=dtype))
        self.pos = nn.Parameter(torch.zeros(self.tokens, hidden, dtype=dtype))
        self.blocks = nn.ModuleList(ViTBlock(hidden, heads, mlp, dtype)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(hidden, eps=EPS, dtype=dtype)

    def forward(self, x):
        b, g, p = x.shape[0], self.grid, self.patch_size
        x = x.to(self.dtype).view(b, g, p, g, p, 3).transpose(2, 3) \
            .reshape(b, self.positions, p * p * 3)
        x = torch.cat([self.cls.expand(b, 1, -1), self.patch(x)], 1) + self.pos
        with sdpa_kernel(ATTENTION):
            for block in self.blocks:
                x = block(x)
        return self.norm(x[:, 1:]).float()

"""The binarizer, the projection head and the decoder as plain PyTorch in
float32, straight from their flax parameter trees (kernels HWIO, dense
kernels (in, out)), and the layers the glyph encoders of ``encoders/``
are built from.

- The attention-UNet binarizer: per level two (3x3 conv, norm, ReLU),
  2x2 max-pool; a bottleneck block; per level up a 2x2 stride-2 transposed
  conv, an attention gate on the skip (skip * sigmoid(psi(relu(Wg up +
  Wx skip)))), the block over [gated skip, up]; a 1x1 head and a sigmoid.
  GroupNorm in groups of min(16, C), eps 1e-6; BatchNorm on its running
  statistics, eps 1e-5.
- The projection head, where there is one: a dense layer per position.
- The attentive LSTM decoder: additive attention over the positions, a
  sigmoid gate on the attended vector, an LSTM cell (gates i, f, g, o, the
  bias on the hidden side) over [embedding; gated vector], a dense head.

:func:`setup` turns TF32 off, so that float32 stays float32 on the card.
Under :func:`low_precision` ("fp8") every operand of a conv or a matmul is
rounded to float8 e4m3 first (weights on a scale per output channel,
activations on one per tensor), the sums and everything else kept in
float32: the reference a precision below the configurations' bfloat16,
the control of the check.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BOS, EOS = 1, 2
FP8_MAX = 448.0
_low = None


def setup() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def low_precision(kind):
    """Within it, conv and matmul operands are rounded to ``kind`` ("fp8",
    or None for float32)."""
    global _low
    if kind not in (None, "fp8"):
        raise ValueError(f"no lower precision {kind!r}")
    prev, _low = _low, kind
    try:
        yield
    finally:
        _low = prev


def _q(x, weight: bool = False):
    """``x`` rounded as :func:`low_precision` says: a weight (its last axis
    the output channels) on a scale per output channel, an activation on
    one scale."""
    if _low is None:
        return x
    amax = x.abs().amax(dim=tuple(range(x.dim() - 1)), keepdim=True) if weight else x.abs().amax()
    scale = amax.clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def to_tensors(tree, device) -> dict:
    """A nested dict of arrays -> the same of float32 tensors on ``device``."""
    return {k: to_tensors(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in tree.items()}


def merged(tree: dict) -> dict:
    """A flax variables dict -> its params with each BatchNorm's running
    ``mean`` and ``var`` beside its ``scale`` and ``bias``."""
    if "params" not in tree:
        return tree

    def merge(p, s):
        out = {k: merge(v, s.get(k, {})) if isinstance(v, dict) else v
               for k, v in p.items()}
        out.update({k: v for k, v in s.items() if k not in p})
        return out
    return merge(tree["params"], tree.get("batch_stats", {}))


def _conv(x, p, stride=1, padding=0):
    y = F.conv2d(_q(x), _q(p["kernel"], True).permute(3, 2, 0, 1), None, stride, padding)
    return y + p["bias"][:, None, None] if "bias" in p else y


def _norm(x, q: dict, j: int, group: int):
    if f"BatchNorm_{j}" in q:
        p = q[f"BatchNorm_{j}"]
        s = (1, -1, 1, 1)
        return ((x - p["mean"].view(s)) * torch.rsqrt(p["var"].view(s) + 1e-5)
                * p["scale"].view(s) + p["bias"].view(s))
    if f"GroupNorm_{j}" in q:
        p = q[f"GroupNorm_{j}"]
        c = x.shape[1]
        return F.group_norm(x, c // min(group, c), p["scale"], p["bias"], 1e-6)
    return x


def _unet_block(x, q):
    for j in range(2):
        x = F.relu(_norm(_conv(x, q[f"Conv_{j}"], padding=1), q, j, 16))
    return x


def unet(p: dict, tiles: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) uint8 tiles -> (T, H, W) float32 probabilities."""
    levels = sum(k.startswith("ConvTranspose_") for k in p)
    x = (tiles.float() / 255.0).permute(0, 3, 1, 2)
    skips = []
    for i in range(levels):
        x = _unet_block(x, p[f"ConvBlock_{i}"])
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)
    x = _unet_block(x, p[f"ConvBlock_{levels}"])
    for j in range(levels):
        up = p[f"ConvTranspose_{j}"]
        w = _q(up["kernel"], True).flip(0, 1).permute(2, 3, 0, 1)
        x = F.conv_transpose2d(_q(x), w, up["bias"], 2)
        g = p[f"AttentionGate_{j}"]
        skip = skips[levels - 1 - j]
        a = F.relu(_conv(x, g["gate_proj"]) + _conv(skip, g["skip_proj"]))
        x = _unet_block(torch.cat([skip * torch.sigmoid(_conv(a, g["psi"])), x], 1),
                        p[f"ConvBlock_{levels + 1 + j}"])
    return torch.sigmoid(_conv(x, p["head"]))[:, 0]


def normalize_crops(crops: torch.Tensor, mean, std) -> torch.Tensor:
    """(N, S, S) crops in 0..255 -> (N, S, S, 3): each stretched min-max to
    0..255, then (x / 255 - mean) / std per channel."""
    x = crops.float()
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    x = torch.where(mx > mn, (x - mn) * (255.0 / torch.clamp(mx - mn, min=1e-12)),
                    torch.zeros_like(x))
    m = torch.tensor(mean, device=x.device)
    s = torch.tensor(std, device=x.device)
    return (x[..., None] / 255.0 - m) / s


def dense(x, p):
    y = _q(x) @ _q(p["kernel"], True)
    return y + p["bias"] if "bias" in p else y


class Decoder:
    """The decoder over one block of rows' features (N, P, E), in the
    precision ``low`` (:func:`low_precision`'s kinds)."""

    def __init__(self, p: dict, enc: torch.Tensor, low=None):
        self.p = p
        self.enc = enc
        self.low = low
        lstm = p["lstm"]
        self.wx = torch.cat([lstm[f"i{g}"]["kernel"] for g in "ifgo"], 1)
        self.wh = torch.cat([lstm[f"h{g}"]["kernel"] for g in "ifgo"], 1)
        self.bh = torch.cat([lstm[f"h{g}"]["bias"] for g in "ifgo"])
        with low_precision(low):
            self.proj = dense(enc, p["enc_att"])
            mean = enc.mean(dim=1)
            self.h = dense(mean, p["init_h"])
            self.c = dense(mean, p["init_c"])

    def step(self, tok: torch.Tensor, h, c):
        """Tokens fed in (N,), state -> (logits (N, V), h, c)."""
        p = self.p
        with low_precision(self.low):
            att = F.relu(self.proj + dense(h, p["dec_att"])[:, None])
            alpha = torch.softmax(dense(att, p["full_att"])[..., 0], dim=1)
            awe = torch.sigmoid(dense(h, p["f_beta"])) * torch.bmm(
                alpha[:, None], self.enc)[:, 0]
            x = torch.cat([p["embedding"]["embedding"][tok], awe], 1)
            i, f, g, o = (_q(x) @ _q(self.wx, True) + _q(h) @ _q(self.wh, True)
                          + self.bh).chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            return dense(h, p["fc"]), h, c


def forced_logits(p: dict, enc: torch.Tensor, tokens: torch.Tensor, low=None):
    """Teacher-forced decode of the given tokens: yields (t, logits (N, V),
    alive (N,)) for each step t while some row has not yet written its EOS
    (a row is alive at the step that writes its EOS)."""
    dec = Decoder(p, enc, low)
    n, length = tokens.shape
    tok = torch.full((n,), BOS, dtype=torch.long, device=enc.device)
    h, c = dec.h, dec.c
    alive = torch.ones(n, dtype=torch.bool, device=enc.device)
    for t in range(length):
        if not bool(alive.any()):
            return
        logits, h, c = dec.step(tok, h, c)
        yield t, logits, alive
        tok = tokens[:, t].long()
        alive = alive & (tok != EOS)


def log_softmax(logits):
    return torch.log_softmax(logits.double(), dim=-1).float()

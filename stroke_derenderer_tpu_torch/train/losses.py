"""Training losses, counterparts of the JAX ``train/losses.py``.

The binarizer learns from (tile, mask) pairs with BCE + Dice on its
sigmoid probabilities; the captioner learns teacher-forced cross-entropy
over the PAD/BOS/EOS + interleaved-vertex token grammar, PAD targets masked
out, optionally with coordinate-aware label smoothing. Every loss is taken
in float32.
"""

from __future__ import annotations

import torch

from stroke_derenderer_tpu_torch.config import PAD

_EPS = 1e-6


def dice_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - Dice coefficient, averaged over the batch. probs, target: (B, H,
    W, 1)."""
    p = probs.float().reshape(probs.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    inter = (p * t).sum(dim=1)
    denom = p.sum(dim=1) + t.sum(dim=1)
    return (1.0 - (2.0 * inter + _EPS) / (denom + _EPS)).mean()


def binarize_loss(probs: torch.Tensor, target: torch.Tensor,
                  dice_weight: float = 1.0) -> torch.Tensor:
    """BCE (probabilities clipped to [1e-6, 1 - 1e-6]) + Dice."""
    target = target.float()
    p = probs.float().clamp(_EPS, 1.0 - _EPS)
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()
    return bce + dice_weight * dice_loss(probs, target)


def caption_loss(logits: torch.Tensor, targets: torch.Tensor,
                 coord_sigma: float = 0.0,
                 count: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced cross-entropy of (B, T, V) logits against (B, T)
    next-token targets, averaged over the positions whose target is not
    PAD. ``count`` replaces this batch's count of such positions as the
    divisor: a data-parallel shard divides its sum by the count of the
    whole batch, so that the shards' losses (and gradients) sum to the
    whole batch's.

    ``coord_sigma`` > 0 spreads a vertex target's mass as a Gaussian over
    the neighbouring coordinates within its own axis range (token 3 + v is
    x = v, 3 + S + v is y = v, S the crop size), never onto the other axis
    or the specials; PAD, BOS and EOS targets stay hard."""
    logits = logits.float()
    targets = targets.long()
    mask = (targets != PAD).float()
    denom = (mask.sum() if count is None else count).clamp(min=1.0)
    if coord_sigma <= 0.0:
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(
            -1, targets[..., None])[..., 0]
        return (ce * mask).sum() / denom

    v = logits.shape[-1]
    s = (v - 3) // 2
    k = max(1, int(3.0 * coord_sigma))
    ds = torch.arange(-k, k + 1, device=logits.device)
    gauss = torch.exp(-0.5 * (ds.float() / coord_sigma) ** 2)
    is_coord = targets >= 3
    axis_start = torch.where(targets < 3 + s, 3, 3 + s)
    neigh = (targets - axis_start)[..., None] + ds
    valid = is_coord[..., None] & (neigh >= 0) & (neigh < s)
    w = torch.where(valid, gauss, 0.0)
    w = torch.where(is_coord[..., None], w, (ds == 0).float())
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=_EPS)
    tok = (targets[..., None] + ds).clamp(0, v - 1)
    lp = torch.log_softmax(logits, dim=-1).gather(-1, tok)
    ce = -(w * lp).sum(dim=-1)
    return (ce * mask).sum() / denom

"""Train steps, the optimizer and its schedule: counterparts of the JAX
``train/steps.py`` and of the ``optax.adamw`` + warmup-cosine schedule that
the JAX ``train/loop.py`` builds.

A step is one update of a model's float32 parameters: zero the gradients,
the loss of one batch in the compute dtype, backward, set the learning
rate of this update, ``AdamW.step()``. The optimizer is
``torch.optim.AdamW`` with optax's defaults (betas 0.9 / 0.999, eps 1e-8,
weight decay 1e-4 on every parameter) and the learning rate of update
``count`` (0 for the first) from :func:`lr_at`, optax's
``warmup_cosine_decay_schedule(0, lr, min(100, steps // 10 + 1), steps)``
in float32, so the first update moves nothing.

With a ``mesh`` (``parallel.mesh``, data parallel) each rank takes its
rows of the batch and the gradients are summed over the dp group before
the update, so that every rank makes the update of the whole batch, as
GSPMD gives the JAX package's sharded step: the binarizer's loss is a mean
over equal shards, so its gradients are summed and divided by dp; the
captioner's divides by the count of real tokens, which differs between
shards, so each shard divides its sum by the count of the whole batch and
the gradients are summed as they are. AdamW then runs the same on every
rank. The step returns the whole batch's loss.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from stroke_derenderer_tpu_torch.config import PAD
from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
from stroke_derenderer_tpu_torch.pipeline.strokes import normalize_crops
from stroke_derenderer_tpu_torch.train.losses import (
    binarize_loss, caption_loss,
)

BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


def warmup_steps(steps: int) -> int:
    return min(100, steps // 10 + 1)


def lr_at(count: int, lr: float, steps: int) -> float:
    """The learning rate of update ``count`` (0-based): a linear warmup from
    0 over :func:`warmup_steps`, then a cosine decay to 0 at ``steps``,
    computed in float32 in optax's order of operations. The cosine itself
    is the correctly rounded float32 one; XLA's float32 cosine is an
    approximation of its own that lies one ulp off at some arguments."""
    f32 = np.float32
    warm = warmup_steps(steps)
    decay = steps - warm
    if decay <= 0:
        raise ValueError(f"steps={steps} leaves no decay after the warmup "
                         f"of {warm} steps")
    if count < warm:
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return float(f32(-lr) * frac + f32(lr))
    t = f32(min(count - warm, decay))
    cos = f32(np.cos(np.float64(f32(math.pi) * t / f32(decay))))
    return float(f32(lr) * (f32(0.5) * (f32(1) + cos)))


def make_optimizer(module: nn.Module) -> torch.optim.AdamW:
    """AdamW over every parameter of ``module`` (weight decay on all, as
    optax's adamw without a mask); the learning rate is set per update."""
    return torch.optim.AdamW(module.parameters(), lr=0.0, betas=BETAS,
                             eps=EPS, weight_decay=WEIGHT_DECAY)


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (optax's ``count``)."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def sum_gradients(module: nn.Module, mesh, divide: bool) -> None:
    """Sum every gradient of ``module`` over the mesh's dp group (divided
    by dp with ``divide``), in one collective on a flat buffer."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = mesh.all_sum(torch.cat([g.reshape(-1) for g in grads]), "dp")
    if divide:
        flat = flat / mesh.shape["dp"]
    ofs = 0
    for g in grads:
        g.copy_(flat[ofs:ofs + g.numel()].view_as(g))
        ofs += g.numel()


def _make_update(module: nn.Module, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], mesh=None,
                 mean_of_shards: bool = True):
    """The update step; under a data-parallel ``mesh`` the gradients and
    the loss are summed over dp, and divided by dp where the loss is the
    mean of equal shards' (``mean_of_shards``)."""
    dp = mesh.shape["dp"] if mesh is not None else 1

    def update(*batch, **kw):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(*batch, **kw)
        loss.backward()
        if dp > 1:
            sum_gradients(module, mesh, mean_of_shards)
            loss = mesh.all_sum(loss.detach(), "dp")
            if mean_of_shards:
                loss = loss / dp
        lr = schedule(update_count(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        for m in module.modules():
            if hasattr(m, "forget_packed"):
                m.forget_packed()
        return loss.detach()
    return update


def device_normalize_u8(crops_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """(B, S, S) uint8 crops -> (B, S, S, 3) float32 model input on their
    device: per-crop min-max rescale, rounded and clipped as the host chain
    ``imagenet_normalize_np(minmax_normalize_np(crop))`` rounds, then
    ImageNet mean/std."""
    return normalize_crops(crops_u8.float(), mean, std, rint=True)


def make_binarizer_train_step(model: nn.Module,
                              optimizer: torch.optim.Optimizer,
                              schedule: Callable[[int], float], mesh=None):
    """``step(tiles, masks) -> loss``: tiles (B, H, W, C) float in [0, 1],
    masks (B, H, W, 1) float {0, 1}, on the model's device (under a
    ``mesh``, this rank's rows)."""
    return _make_update(model, lambda tiles, masks: binarize_loss(
        model(tiles), masks), optimizer, schedule, mesh)


def scheduled_sampling_mask(shape, step: int, sample_prob: float,
                            total_steps: int, ramp_frac: float, seed: int,
                            device) -> torch.Tensor:
    """Which input tokens take the model's own previous prediction at
    ``step``: each with probability ``clip(step / max(total_steps *
    ramp_frac, 1), 0, 1) * sample_prob``, drawn from a generator seeded by
    (``seed``, ``step``) on ``device``."""
    ramp = min(max(step / max(total_steps * ramp_frac, 1.0), 0.0), 1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(
        1)[0]))
    return torch.rand(shape, generator=gen, device=device) < (
        sample_prob * ramp)


class Captioner(nn.Module):
    """The encoder and the decoder as one module, so that one optimizer
    and one parameter naming (``encoder.*``, ``decoder.*``) cover both."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder


def make_captioner_train_step(captioner: Captioner,
                              optimizer: torch.optim.Optimizer,
                              schedule: Callable[[int], float],
                              enc_image_size: int = 14,
                              coord_sigma: float = 0.0,
                              sample_prob: float = 0.0,
                              total_steps: int = 0,
                              ss_ramp_frac: float = 1.0,
                              normalize_on_device: bool = False,
                              mean=None, std=None, seed: int = 0,
                              mesh=None):
    """``step(images, tokens_in, tokens_out, step_idx=None, take=None) ->
    loss``. Teacher forcing: ``tokens_in`` are the targets shifted right.
    ``images`` are normalized (B, S, S, 3) float32 crops, or (B, S, S)
    uint8 crops with ``normalize_on_device``. Under a ``mesh`` the inputs
    are this rank's rows, and the default ``take`` is this rank's rows of
    the whole batch's.

    ``sample_prob`` > 0 turns on scheduled sampling: a first teacher-forced
    pass without gradients gives the model's own predictions, and each
    input token that is not PAD is replaced by the previous prediction where
    ``take`` is set (by default :func:`scheduled_sampling_mask` at
    ``step_idx``) before the loss pass."""
    encoder, decoder = captioner.encoder, captioner.decoder

    def encode(images):
        if normalize_on_device:
            images = device_normalize_u8(images, mean, std)
        return encode_postprocess(encoder(images), enc_image_size)

    def loss_fn(images, tokens_in, tokens_out, step_idx=None, take=None):
        seq = encode(images)
        if sample_prob > 0.0:
            with torch.no_grad():
                preds = decoder(seq, tokens_in).argmax(dim=-1).to(
                    tokens_in.dtype)
            prev_pred = torch.cat([tokens_in[:, :1], preds[:, :-1]], dim=1)
            if take is None:
                b = tokens_in.shape[0]
                take = scheduled_sampling_mask(
                    (b * dp,) + tokens_in.shape[1:], int(step_idx),
                    sample_prob, total_steps, ss_ramp_frac, seed,
                    tokens_in.device)
                if dp > 1:
                    take = take[mesh.rows(b * dp)]
            tokens_in = torch.where(take & (tokens_in != PAD), prev_pred,
                                    tokens_in)
        count = None
        if dp > 1:
            count = mesh.all_sum((tokens_out != PAD).sum().float(), "dp")
        return caption_loss(decoder(seq, tokens_in), tokens_out,
                            coord_sigma=coord_sigma, count=count)

    dp = mesh.shape["dp"] if mesh is not None else 1
    return _make_update(captioner, loss_fn, optimizer, schedule, mesh,
                        mean_of_shards=False)

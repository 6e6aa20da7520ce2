"""Convolution, Dense and normalization calls with flax's rounding.

The modules keep float32 parameters and run in the dtype of their input.
A flax ``Conv``/``ConvTranspose``/``Dense`` in bfloat16 rounds the product
to bfloat16 and then adds the bias in bfloat16; ``F.conv2d`` with a bias
folds it in before its one rounding, so the bias is added separately here.
A flax ``GroupNorm`` takes its statistics and its affine in float32 and
rounds the result to the input's dtype. A flax ``BatchNorm`` in inference
mode (``use_running_average=True``) does the same with its float32 running
statistics: ``x - mean`` promotes the input to float32, ``rsqrt(var + eps)
* scale`` and the bias stay float32, and the result is rounded once.
Under ``quant="int8"`` a convolution contracts in int8
(``ops.quant.int8_conv2d``) on the weight already cast to the input's
dtype, as flax promotes its kernel before the injected conv sees it.

Under a mesh whose width is split over tp (``parallel.mesh.spmd`` with
``width``), a padded convolution takes its halo columns from its tp
neighbours instead of zeros (zeros stay at the tile's true edges), and
GroupNorm takes its statistics over the whole width: the tp group gathers
the tensor, normalizes it as one rank would and keeps its own columns.
Summing per-rank statistics instead gives the mean and variance in
another order of sums than the unsharded kernel's, a last-bit difference
that moved 8 of 54,528 float32 mask pixels of a random UNet
(``tests/test_torch_multihost.py``), so the gather keeps the sharded
output the unsharded one exactly.

A layer laid out column-parallel for training over tp
(``parallel.mesh.shard_columns``) holds its rank's output channels of the
kernel; :func:`conv` gathers the outputs over tp before the (replicated)
bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stroke_derenderer_tpu_torch.ops.quant import conv_injection
from stroke_derenderer_tpu_torch.parallel.mesh import (
    active, column_parallel,
)


class BatchNorm(nn.Module):
    """The parameters of a flax ``BatchNorm`` in inference mode: ``weight``
    and ``bias`` (flax's ``scale`` and ``bias``) and the running
    ``running_mean`` and ``running_var`` (its ``batch_stats``). eps is
    flax's default, 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


def make_norm(kind: str, channels: int, group_size: int) -> nn.Module | None:
    """The norm layer of a ``norm`` config value: ``"group"`` (groups of
    ``min(group_size, channels)`` channels, eps 1e-6, flax's default),
    ``"batch"`` or ``"none"`` (no layer)."""
    if kind == "group":
        return nn.GroupNorm(channels // min(group_size, channels), channels,
                            eps=1e-6)
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "none":
        return None
    raise ValueError(f"norm must be 'group', 'batch' or 'none', got {kind!r}")


def conv(x, layer: nn.Conv2d | nn.ConvTranspose2d, stride: int = 1,
         padding: int = 0, transposed: bool = False, quant: str = "none"):
    w = layer.weight.to(x.dtype)
    int8 = conv_injection(quant)
    ctx = active()
    if padding and not transposed and ctx is not None and ctx.width:
        x = ctx.mesh.halo(x, padding)
        padding = (padding, 0)

    def product(x):
        if transposed:
            return F.conv_transpose2d(x, w, None, stride)
        if int8 is not None:
            return int8(x, w, stride, padding)
        return F.conv2d(x, w, None, stride, padding)

    tp = getattr(layer, "tp_mesh", None)
    y = product(x) if tp is None else column_parallel(product, x, tp, 1)
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype)[:, None, None]
    return y


def linear(x, layer: nn.Linear):
    """A flax ``Dense`` on x's last axis: the product in x's dtype, then the
    bias added in x's dtype."""
    y = torch.matmul(x, layer.weight.t().to(x.dtype))
    return y + layer.bias.to(x.dtype)


def group_norm(x, norm: nn.GroupNorm):
    ctx = active()
    if ctx is not None and ctx.width and ctx.mesh.shape["tp"] > 1:
        return _group_norm_tp(x, norm, ctx.mesh)
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


def _group_norm_tp(x, norm: nn.GroupNorm, mesh):
    """:func:`group_norm` of an NCHW tensor whose width is split over the
    mesh's tp group: normalized over the gathered width, this rank's
    columns kept."""
    w = x.shape[-1]
    full = mesh.all_gather(x, "tp", dim=-1)
    y = F.group_norm(full.float(), norm.num_groups, norm.weight, norm.bias,
                     norm.eps)
    return y[..., mesh.tp_index * w:(mesh.tp_index + 1) * w].to(x.dtype)


def batch_norm(x, norm: BatchNorm):
    """NCHW ``x`` through ``norm``'s running statistics, in flax's order."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(norm.running_var + norm.eps) * norm.weight
    y = (x.float() - norm.running_mean.view(shape)) * mul.view(shape)
    return (y + norm.bias.view(shape)).to(x.dtype)


def normalize(x, norm: nn.Module | None):
    """``x`` through a layer of :func:`make_norm` (None: unchanged)."""
    if norm is None:
        return x
    if isinstance(norm, BatchNorm):
        return batch_norm(x, norm)
    return group_norm(x, norm)

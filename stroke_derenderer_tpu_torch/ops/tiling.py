"""Tile geometry for the binarizer: the plan and the numpy cut and stitch
on the host, and their torch counterparts for the device (the JAX
``ops/tiling.py``).

``num_tiles = w // (target_width - overlap) + 1`` for w >= target_width,
else one right-padded tile; tile i covers columns [i * w_unpad,
min((i + 1) * w_unpad + overlap, w)); the stitch pastes tile i's unpadded
columns at the running offset sum_{k<i}(width_k - overlap), taking the
elementwise max where tiles overlap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TilePlan:
    img_width: int
    target_width: int
    overlap: int
    num_tiles: int
    widths: tuple[int, ...]  # unpadded width of each tile
    starts: tuple[int, ...]  # source column of each tile

    @property
    def stitch_starts(self) -> tuple[int, ...]:
        out, pos = [], 0
        for wd in self.widths:
            out.append(pos)
            pos += wd - self.overlap
        return tuple(out)


def plan_tiles(img_width: int, target_width: int, overlap: int) -> TilePlan:
    if img_width < target_width:
        return TilePlan(img_width, target_width, overlap, 1, (img_width,), (0,))
    num = img_width // (target_width - overlap) + 1
    w_unpad = img_width // num
    starts = [i * w_unpad for i in range(num)]
    widths = [min((i + 1) * w_unpad + overlap, img_width) - s
              for i, s in enumerate(starts)]
    return TilePlan(img_width, target_width, overlap, num, tuple(widths),
                    tuple(starts))


def cut_tiles_np(img: np.ndarray, plan: TilePlan,
                 pad_value: int = 0) -> np.ndarray:
    """(H, W, C) -> (num_tiles, H, target_width, C)."""
    h, _, c = img.shape
    out = np.full((plan.num_tiles, h, plan.target_width, c), pad_value,
                  dtype=img.dtype)
    for i, (s, wd) in enumerate(zip(plan.starts, plan.widths)):
        out[i, :, :wd] = img[:, s:s + wd]
    return out


def stitch_tiles_np(tiles: np.ndarray, plan: TilePlan) -> np.ndarray:
    """(num_tiles, H, target_width, C) -> (H, img_width, C), max-blend."""
    _, h, _, c = tiles.shape
    canvas = np.zeros((h, plan.img_width, c), dtype=tiles.dtype)
    for i, (s, wd) in enumerate(zip(plan.stitch_starts, plan.widths)):
        canvas[:, s:s + wd] = np.maximum(canvas[:, s:s + wd], tiles[i, :, :wd])
    return canvas


def _cut_columns(plan: TilePlan):
    """(T, target_width) source column of each tile column (0 past the
    tile's width) and whether it lies inside the tile."""
    tw = np.arange(plan.target_width)[None, :]
    valid = tw < np.asarray(plan.widths)[:, None]
    col = np.asarray(plan.starts)[:, None] + tw
    return np.where(valid, np.minimum(col, plan.img_width - 1), 0), valid


def cut_tiles(img: torch.Tensor, plan: TilePlan,
              pad_value: int = 0) -> torch.Tensor:
    """(..., H, W, C) -> (..., num_tiles, H, target_width, C) on the
    tensor's device: one gather of precomputed columns, ``pad_value`` past
    each tile's width. Equals :func:`cut_tiles_np` on every image."""
    col, valid = _cut_columns(plan)
    dev = img.device
    tiles = img.index_select(-2, torch.from_numpy(col.reshape(-1)).to(dev))
    tiles = tiles.unflatten(-2, col.shape).movedim(-3, -4)
    keep = torch.from_numpy(valid).to(dev)[:, None, :, None]
    return torch.where(keep, tiles,
                       torch.tensor(pad_value, dtype=img.dtype, device=dev))


def stitch_tiles(tiles: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(..., num_tiles, H, target_width, C) -> (..., H, img_width, C): a
    scatter-max into a zero canvas over precomputed destination columns;
    columns past a tile's width go to one extra column that is dropped.
    Equals :func:`stitch_tiles_np` for any dtype with a zero floor. The
    scatter runs in int32 for integer tiles (the atomics of the card's
    scatter-max are certain for that type) and casts back."""
    t, h, tw, c = tiles.shape[-4:]
    lead = tiles.shape[:-4]
    dst = np.asarray(plan.stitch_starts)[:, None] + np.arange(tw)[None, :]
    valid = np.arange(tw)[None, :] < np.asarray(plan.widths)[:, None]
    dst = np.where(valid, dst, plan.img_width).reshape(-1)
    work = torch.int32 if not tiles.dtype.is_floating_point else tiles.dtype
    src = tiles.movedim(-4, -3).reshape(*lead, h, t * tw, c).to(work)
    idx = torch.from_numpy(dst).to(tiles.device).view(-1, 1).expand(
        t * tw, c).expand(*lead, h, t * tw, c)
    canvas = torch.zeros(*lead, h, plan.img_width + 1, c, dtype=work,
                         device=tiles.device)
    canvas.scatter_reduce_(-2, idx, src, "amax")
    return canvas[..., :plan.img_width, :].to(tiles.dtype)

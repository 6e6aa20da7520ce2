"""Glyph crops built on the device from a group-id image.

Counterpart of the JAX ``ops/device_partition.py``. The host keeps the
ragged geometry (connected components, interval grouping, the scalar resize
arithmetic) and sends a (H, W) group-id image (-1 = background) plus, per
group and axis, the first source index and the second bilinear weight of
each output texel. The device rebuilds each group's canvas as
``gid == g`` and resizes and pads it with two batched matrix products.

The group-id image travels packed, as the JAX package sends it
(:func:`pack_gid` on the host, :func:`unpack_gid` on the device): run-length
encoded where that is well under the dense form (``StrokesConfig.gid_rle``,
on by default), else nibble-, int8- or int16-packed. Packing is lossless, so
the crops are those of the dense image.

Known (deliberate) deviation, kept from the JAX package: a group whose union
bounding box is entirely foreground stays foreground here, where the host
crop path would min-max-normalize it to all zeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stroke_derenderer_tpu_torch.ops.connected import (
    connected_components_with_boxes,
)
from stroke_derenderer_tpu_torch.ops.grouping import (
    get_pad_edges, group_intervals,
)
from stroke_derenderer_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class PartitionPlan:
    """Host bookkeeping for one image's glyph groups. Per axis, ``*i0``
    holds absolute first source indices (int16) and ``w*1`` the second
    lerp weight (float32, -1.0 where the output texel is padding);
    ``*last`` is the last valid source index of each group."""
    gid_img: np.ndarray   # (H, W) int16: pixel -> group id, -1 = background
    yi0: np.ndarray       # (N, S) int16
    wy1: np.ndarray       # (N, S) float32
    ylast: np.ndarray     # (N,) int16
    xi0: np.ndarray       # (N, S) int16
    wx1: np.ndarray       # (N, S) float32
    xlast: np.ndarray     # (N,) int16
    partitions: list[dict]  # translate1 / ratio / translate2 per group
    ink: np.ndarray | None = None  # (N,) foreground pixels per group

    COORD_KEYS = ("yi0", "wy1", "ylast", "xi0", "wx1", "xlast")


def _axis_coords(src0, src_len, rs_len, pad0, out: int):
    """First source indices and second weights for one output axis, per
    group: half-pixel centres and OpenCV clamping as in ops/resize.py,
    shifted by the crop origin and the pad offset."""
    src0 = np.atleast_1d(np.asarray(src0, np.float64))[:, None]
    src_len = np.atleast_1d(np.asarray(src_len, np.float64))[:, None]
    rs_len = np.atleast_1d(np.asarray(rs_len, np.float64))[:, None]
    pad0 = np.atleast_1d(np.asarray(pad0, np.float64))[:, None]
    i = np.arange(out, dtype=np.float64)[None, :]
    c = (i - pad0 + 0.5) * (src_len / rs_len) - 0.5
    x0 = np.floor(c)
    f = c - x0
    f = np.where(x0 < 0, 0.0, f)
    x0 = np.clip(x0, 0, src_len - 1)
    f = np.where(x0 >= src_len - 1, 0.0, f)
    valid = (i >= pad0) & (i < pad0 + rs_len)
    w1 = np.where(valid, f, -1.0)
    return (src0 + x0).astype(np.int16), w1.astype(np.float32)


def plan_partitions(img_bin: np.ndarray, margin: int, out_size: int
                    ) -> PartitionPlan | None:
    """Islands -> groups -> per-group interpolation plan; None when the mask
    has no foreground. The spans ``sd.strokes.components`` (the connected
    components) and ``sd.strokes.grouping`` (the rest)."""
    img_bin = np.asarray(img_bin)
    if img_bin.ndim == 3:
        img_bin = img_bin[:, :, 0]
    with span("sd.strokes.components"):
        labels, boxes, areas = connected_components_with_boxes(
            img_bin.astype(np.uint8), with_area=True)
    if len(boxes) == 0:
        return None
    with span("sd.strokes.grouping"):
        return _plan_groups(labels, boxes, areas, img_bin.shape, margin,
                            out_size)


def _plan_groups(labels, boxes, areas, shape, margin: int, out_size: int
                 ) -> PartitionPlan:
    """:func:`plan_partitions` after the components: the islands' boxes
    grown by ``margin`` and grouped, the label map and each group's
    coordinates."""
    h, w = shape
    exs = np.maximum(boxes[:, 0] - margin, 0)
    eys = np.maximum(boxes[:, 1] - margin, 0)
    exf = np.minimum(boxes[:, 0] + boxes[:, 2] + margin + 1, w)
    eyf = np.minimum(boxes[:, 1] + boxes[:, 3] + margin + 1, h)
    order = np.argsort(exs, kind="stable")
    lab = (order + 1).astype(np.int64)
    exs, eys, exf, eyf = exs[order], eys[order], exf[order], eyf[order]
    areas_sorted = np.asarray(areas)[order]

    # Group width budget = image height (targets are (h, h) canvases).
    groups = group_intervals(list(zip(exs.tolist(), exf.tolist())), h)

    group_of_label = np.full(len(boxes) + 1, -1, np.int16)
    tops, lefts, ghs, gws, rs_hs, rs_ws, pad_ts, pad_ls = ([] for _ in range(8))
    partitions, inks = [], []
    for g, inds in enumerate(groups):
        ii = np.asarray(inds)
        group_of_label[lab[ii]] = g
        inks.append(int(areas_sorted[ii].sum()))
        top, left = int(eys[ii].min()), int(exs[ii].min())
        gh, gw = int(eyf[ii].max()) - top, int(exf[ii].max()) - left
        # resize_and_pad_np's scalar arithmetic with margin 1.
        inner = out_size - 2
        scale = min(inner / gh, inner / gw)
        rs_w = int(min(np.rint(scale * gw), inner))
        rs_h = int(min(np.rint(scale * gh), inner))
        tops.append(top)
        lefts.append(left)
        ghs.append(gh)
        gws.append(gw)
        rs_hs.append(rs_h)
        rs_ws.append(rs_w)
        pad_ts.append(get_pad_edges(out_size - rs_h)[0])
        pad_ls.append(get_pad_edges(out_size - rs_w)[0])
        partitions.append({
            "translate1": (left, top),
            "ratio": (rs_w / gw + rs_h / gh) / 2,
            "translate2": ((out_size - rs_w) / 2, (out_size - rs_h) / 2),
        })

    yi0, wy1 = _axis_coords(tops, ghs, rs_hs, pad_ts, out_size)
    xi0, wx1 = _axis_coords(lefts, gws, rs_ws, pad_ls, out_size)
    return PartitionPlan(
        gid_img=group_of_label[labels].astype(np.int16),
        yi0=yi0, wy1=wy1,
        ylast=(np.asarray(tops) + np.asarray(ghs) - 1).astype(np.int16),
        xi0=xi0, wx1=wx1,
        xlast=(np.asarray(lefts) + np.asarray(gws) - 1).astype(np.int16),
        partitions=partitions, ink=np.asarray(inks, np.int64))


_RLE_BUCKET = 2048  # run counts are padded to a multiple of this


def pack_gid(gid: np.ndarray, max_groups: int,
             allow_rle: bool = True) -> tuple:
    """A group-id image or stack, (..., W) int16 with -1 for background, ->
    (packed, fmt) for the host-to-device hop, the JAX package's formats:

    - ``"rle:<d0>x<d1>..."``: runs over the row-major flattening, packed =
      (starts int32 (R,), vals int16 (R,)) with R padded to a multiple of
      ``_RLE_BUCKET`` (pad starts = the pixel count); chosen only where its
      bytes are under 0.6 of the dense form's;
    - ``"nib"``: ids + 1 two to a byte (high nibble first), where every id
      fits a nibble (``max_groups`` <= 15) and W is even;
    - ``"i8"`` (``max_groups`` < 128), else ``"i16"``."""
    if max_groups <= 15 and gid.shape[-1] % 2 == 0:
        dense_fmt, dense_bytes = "nib", gid.size // 2
    elif max_groups < 128:
        dense_fmt, dense_bytes = "i8", gid.size
    else:
        dense_fmt, dense_bytes = "i16", 2 * gid.size
    if allow_rle:
        flat = np.ascontiguousarray(gid, np.int16).reshape(-1)
        starts = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        r = starts.size + 1
        rb = -(-r // _RLE_BUCKET) * _RLE_BUCKET
        if rb * 6 < 0.6 * dense_bytes:
            st = np.full(rb, flat.size, np.int32)
            st[0], st[1:r] = 0, starts
            vals = np.zeros(rb, np.int16)
            vals[0], vals[1:r] = flat[0], flat[starts]
            shape = "x".join(str(d) for d in gid.shape)
            return (st, vals), f"rle:{shape}"
    # The dense form is built only where it is sent.
    if dense_fmt == "nib":
        v = (gid + 1).astype(np.uint8)
        return (v[..., 0::2] << 4) | v[..., 1::2], "nib"
    return gid.astype(np.int8 if dense_fmt == "i8" else np.int16), dense_fmt


def unpack_gid(packed, fmt: str) -> torch.Tensor:
    """The inverse of :func:`pack_gid` on the packed tensors' device ->
    int32 group ids. Runs expand as ones scattered at the run starts, then
    a cumulative sum (the JAX version's formulation); the padded starts,
    equal to the pixel count, land in one extra element that is cut."""
    if fmt.startswith("rle:"):
        shape = tuple(int(d) for d in fmt[4:].split("x"))
        starts, vals = packed
        n = int(np.prod(shape))
        seg = torch.zeros(n + 1, dtype=torch.int32, device=vals.device)
        seg.scatter_add_(0, starts.long(), torch.ones_like(starts,
                                                           dtype=torch.int32))
        k = torch.cumsum(seg[:n], 0) - 1
        return vals[k].to(torch.int32).reshape(shape)
    if fmt == "nib":
        hi = (packed >> 4).to(torch.int32) - 1
        lo = (packed & 15).to(torch.int32) - 1
        return torch.stack([hi, lo], dim=-1).reshape(
            packed.shape[:-1] + (packed.shape[-1] * 2,))
    return packed.to(torch.int32)


def _expand_axis(i0, w1, last):
    """(i0, w1 with the -1 sentinel, last) -> (i0, i1, w0, w1)."""
    valid = w1 >= 0.0
    w1 = torch.clamp(w1, min=0.0)
    w0 = torch.where(valid, 1.0 - w1, torch.zeros_like(w1))
    i0 = i0.long()
    i1 = torch.minimum(i0 + 1, last.long()[:, None])
    return i0, i1, w0, w1


def _interp_rows(i0, w1, last, size: int):
    """(N, S) compact coordinates -> (N, S, size) interpolation rows."""
    i0, i1, w0, w1 = _expand_axis(i0, w1, last)
    s = torch.arange(size, device=i0.device)[None, None, :]
    return (w0[:, :, None] * (s == i0[:, :, None])
            + w1[:, :, None] * (s == i1[:, :, None]))


def gather_crops(gid_img, coords, gid_fmt: str = "i16") -> torch.Tensor:
    """(H, W) group-id image (packed as :func:`pack_gid` gives ``gid_fmt``)
    + the plan's compact coordinates, as tensors on one device -> (N, S, S)
    float32 crops with values 0..255. The float32 products need TF32 off on
    the card (``device.resolve_device``)."""
    gid = unpack_gid(gid_img, gid_fmt)
    g = torch.arange(coords[0].shape[0], device=gid.device,
                     dtype=torch.int32)
    src = gid[None] == g[:, None, None]
    return _interp_crops(src.float() * 255.0, coords)


def gather_crops_batched(gid_stack, img_idx: torch.Tensor,
                         local_id: torch.Tensor, coords,
                         gid_fmt: str = "i16") -> torch.Tensor:
    """Cross-image variant: ``gid_stack`` (I, H, W) holds every image's
    group-id image, padded with -1 (packed as ``gid_fmt``); ``img_idx`` and
    ``local_id`` (N,) give each glyph row's image and its group id there;
    ``coords`` as for :func:`gather_crops`, one row per glyph. -> (N, S, S)
    float32 crops, the rows :func:`gather_crops` gives for each image."""
    gid = unpack_gid(gid_stack, gid_fmt)
    src = gid[img_idx.long()] == local_id.to(torch.int32)[:, None, None]
    return _interp_crops(src.float() * 255.0, coords)


def _interp_crops(src: torch.Tensor, coords) -> torch.Tensor:
    """(N, H, W) float32 source canvases + compact interpolation rows ->
    (N, S, S) crops: resize and pad as two batched matrix products."""
    yi0, wy1, ylast, xi0, wx1, xlast = coords
    _, hh, ww = src.shape
    ry = _interp_rows(yi0, wy1, ylast, hh)       # (N, S, H)
    rx = _interp_rows(xi0, wx1, xlast, ww)       # (N, S, W)
    crops = torch.bmm(torch.bmm(ry, src), rx.transpose(1, 2))
    return torch.clamp(torch.round(crops), 0.0, 255.0)

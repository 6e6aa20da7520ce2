"""Binarization: resize -> tile -> attention-UNet -> threshold -> stitch.

Counterpart of the JAX ``pipeline/binarize.py``, in its two modes:

- bucketed (the default): tiles are cut and stitched on the host, the tile
  batch is padded to a multiple of ``config.batch_bucket`` and runs through
  the UNet on the device in one call;
- fused (``fused=True``): cut, UNet, threshold and stitch all on the
  device, one program per tile plan.

``binarize_images`` batches across images: width groups of at least
``config.fused_batch_min`` images (every group with ``fused=True``) go
through the batched fused program, which uploads the resized lines and
downloads bit-packed masks; the rest share one bucketed tile batch. The
output of each image is a (height, W_rs, 1) uint8 image in {0, 255} at the
height-normalized resolution, the same in every mode.

With a ``mesh`` (``parallel.mesh``) every rank runs this code on the same
images: the UNet's parameters are replicated, the tile batch is padded to
a multiple of lcm(``batch_bucket``, dp) (the fused program's images to a
multiple of dp) and sharded on dp, and, when tp divides the tile width
(``parallel.mesh.tile_sharding``), each rank of a tp group takes its own
columns of every tile (the 3x3 convolutions exchange halos, GroupNorm sums
over tp). The masks are gathered over tp (columns) and dp (rows), so every
rank holds all of them.

While a profile records (``utils.profiling``), ``binarize_images`` is the
span ``sd.binarize``, with ``prep`` (the host resize, the tile cut and
stacking), ``launch`` (the upload and the enqueue of the device work),
``wait`` (the blocking download) and ``unpack`` (the host stitch or the
unpacking of the bits) inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from stroke_derenderer_tpu_torch.config import BinarizerConfig
from stroke_derenderer_tpu_torch.device import dtype_of, resolve_device
from stroke_derenderer_tpu_torch.models.unet import AttentionUNet
from stroke_derenderer_tpu_torch.ops.resize import resize_to_height_np
from stroke_derenderer_tpu_torch.ops.tiling import (
    TilePlan, cut_tiles, cut_tiles_np, plan_tiles, stitch_tiles,
    stitch_tiles_np,
)
from stroke_derenderer_tpu_torch.parallel.mesh import (
    padded_batch, spmd, tile_sharding,
)
from stroke_derenderer_tpu_torch.utils.profiling import (
    download, span, upload,
)
from stroke_derenderer_tpu_torch.weights import (
    from_flax_unet, init_binarizer, read_msgpack,
)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits' bit order


def _prep_line(image: np.ndarray, cfg: BinarizerConfig,
               keep_gray: bool = False) -> np.ndarray:
    """Height-normalize; a one-channel line is repeated to the model's
    channels. With ``keep_gray`` (for a program that repeats the channel on
    the device) an achromatic RGB line drops to one channel before the
    resize and stays so: the resize works per channel, so the result is the
    same."""
    img = np.asarray(image)
    if (keep_gray and img.ndim == 3 and img.shape[2] == 3
            and np.array_equal(img[..., 0], img[..., 1])
            and np.array_equal(img[..., 0], img[..., 2])):
        img = img[..., :1]
    img_rs = resize_to_height_np(img, cfg.height)
    if img_rs.ndim == 2:
        img_rs = img_rs[:, :, None]
    if not keep_gray and img_rs.shape[2] == 1 and cfg.channels == 3:
        img_rs = np.repeat(img_rs, 3, axis=2)
    return img_rs


class Binarizer:
    def __init__(self, config: BinarizerConfig, weights_path=None,
                 device=None, fused: bool = False, variables=None,
                 mesh=None):
        """``weights_path``: the UNet's flax msgpack file; ``variables``:
        its flax variables (or params) tree given in memory instead, as an
        ONNX import gives it; with neither, random weights
        (``weights.init_binarizer``, seed 0). ``config.norm`` is
        ``"group"``, ``"batch"`` or ``"none"``; ``config.quant`` ``"int8"``
        runs the UNet's int8 conv stacks (``ops.quant``). ``fused``: cut and
        stitch on the device (one program per tile plan), and every width
        group of ``binarize_images`` through the batched fused program.
        Every UNet call sees the tile batch the JAX package gives its
        program (padded to ``config.batch_bucket`` on the bucketed path), so
        that int8's per-tensor scale spans the same tiles. ``mesh``: this
        rank's ``parallel.mesh.Mesh``; the pipeline then runs on the mesh's
        device (``device`` is not read)."""
        self.config = cfg = config
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        # The tp extent of the tile width (1: dp only).
        self._tp = 1
        if mesh is not None and "tp" in tile_sharding(mesh, 4, cfg.width):
            self._tp = mesh.shape["tp"]
            levels = 2 ** len(cfg.features)
            if (cfg.width // self._tp) % levels:
                raise ValueError(
                    f"a tile width of {cfg.width} over tp={self._tp} leaves "
                    f"{cfg.width // self._tp} columns a rank, not a multiple "
                    f"of the UNet's {levels}-fold pooling")
        if variables is None and weights_path is not None:
            variables = read_msgpack(weights_path)
        if variables is None:
            model = init_binarizer(cfg)
        else:
            model = AttentionUNet(cfg.features, cfg.bottleneck, cfg.channels,
                                  dtype=dtype_of(cfg.compute_dtype),
                                  norm=cfg.norm, quant=cfg.quant)
            model.load_state_dict(from_flax_unet(variables,
                                                 len(cfg.features)))
        self.model = model.to(self.device).eval()
        self.fused = fused

    def _mask(self, tiles: torch.Tensor) -> torch.Tensor:
        """(T, H, W, C) uint8 tiles on the device -> (T, H, W, 1) uint8
        masks in {0, 255}; a one-channel tile is repeated to the model's
        channels. Under the mesh ``tiles`` are this rank's tiles (and,
        when the width is split, its columns of them), and so is the
        result."""
        x = tiles.float() / 255.0
        if x.shape[-1] == 1 and self.config.channels != 1:
            x = x.repeat(1, 1, 1, self.config.channels)
        with spmd(self.mesh, width=self._tp > 1):
            probs = self.model(x)
        return torch.where(probs > self.config.bin_thr, 255, 0).to(torch.uint8)

    def _sharded_mask(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`_mask` under the mesh: ``x`` this rank's rows of a tile
        batch sharded on dp, whole tiles; this rank's columns of them
        where the width is split, then every rank's masks gathered over tp
        and dp (the whole batch, on every rank)."""
        mesh = self.mesh
        if self._tp > 1:
            w = x.shape[2] // self._tp
            x = x[:, :, mesh.tp_index * w:(mesh.tp_index + 1) * w]
        m = self._mask(x.contiguous())
        if self._tp > 1:
            m = mesh.all_gather(m, "tp", dim=2)
        return mesh.all_gather(m, "dp", dim=0)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return upload(self.device, arr)[0]

    @torch.inference_mode()
    def binarize_tiles(self, tiles_u8: np.ndarray) -> np.ndarray:
        """(T, H, W, C) uint8 tiles -> (T, H, W, 1) uint8 masks in {0, 255}."""
        t = tiles_u8.shape[0]
        with span("sd.binarize.launch"):
            if self.mesh is None:
                # The JAX package pads the batch on the host and uploads
                # the pad tiles too; the port pads on the device and
                # uploads T.
                tb = _round_up(t, self.config.batch_bucket)
                x = torch.zeros((tb,) + tiles_u8.shape[1:],
                                dtype=torch.uint8, device=self.device)
                x[:t] = self._upload(tiles_u8)
                masks = self._mask(x)[:t]
            else:
                tb = padded_batch(t, self.config.batch_bucket,
                                  self.mesh.shape["dp"])
                x = np.zeros((tb,) + tiles_u8.shape[1:], np.uint8)
                x[:t] = tiles_u8
                local = self._upload(x[self.mesh.rows(tb)])
                masks = self._sharded_mask(local)[:t]
        with span("sd.binarize.wait"):
            return download(masks)

    @torch.inference_mode()
    def _fused_batch(self, imgs_u8: np.ndarray, plan: TilePlan) -> torch.Tensor:
        """(B, H, W, C) resized lines of one tile plan -> (B, H, ceil(W / 8))
        uint8 masks bit-packed on the device, still there: device cut, the
        channel repeated on the device when C = 1, UNet, threshold, stitch,
        pack."""
        b = imgs_u8.shape[0]
        if self.mesh is not None:
            # The images padded to a multiple of dp, as the JAX package
            # pads them; each rank cuts the tiles of its own.
            bp = _round_up(b, self.mesh.shape["dp"])
            rows = self.mesh.rows(bp)
            x = np.zeros((bp,) + imgs_u8.shape[1:], np.uint8)
            x[:b] = imgs_u8
            tiles = cut_tiles(self._upload(x[rows]), plan)
            t = tiles.shape[1]
            mask = self._sharded_mask(tiles.flatten(0, 1)).unflatten(
                0, (bp, t))[:b]
        else:
            tiles = cut_tiles(self._upload(imgs_u8), plan)
            t = tiles.shape[1]
            mask = self._mask(tiles.flatten(0, 1)).unflatten(0, (b, t))
        out = stitch_tiles(mask, plan)[..., 0] > 0           # (B, H, W)
        wp = _round_up(plan.img_width, 8)
        bits = torch.zeros(out.shape[:2] + (wp,), dtype=torch.int32,
                           device=out.device)
        bits[..., :plan.img_width] = out.to(torch.int32)
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                               device=out.device)
        return (bits.unflatten(-1, (wp // 8, 8)) * weights).sum(-1).to(
            torch.uint8)

    def _binarize_images_fused(self, images, plans: list[TilePlan],
                               idxs_all: list[int], out: list) -> None:
        """Same-width images in groups through :meth:`_fused_batch`, each
        group split into ``config.io_chunks`` sub-dispatches, all queued on
        the device before the first download. Results go into ``out`` at
        their original indices."""
        cfg = self.config
        by_plan: dict[TilePlan, list[int]] = {}
        for i in idxs_all:
            by_plan.setdefault(plans[i], []).append(i)
        pending = []  # (packed masks on the device, indices, plan)
        for plan, idxs in by_plan.items():
            nch = max(1, (len(idxs) + cfg.io_chunks - 1) // cfg.io_chunks)
            for c0 in range(0, len(idxs), nch):
                chunk = idxs[c0:c0 + nch]
                with span("sd.binarize.prep"):
                    prepped = [_prep_line(images[i], cfg, keep_gray=True)
                               for i in chunk]
                    cmax = max(p.shape[-1] for p in prepped)
                    batch = np.stack([p if p.shape[-1] == cmax
                                      else np.repeat(p, cmax, axis=2)
                                      for p in prepped])
                with span("sd.binarize.launch"):
                    pending.append((self._fused_batch(batch, plan), chunk,
                                    plan))
        for packed, chunk, plan in pending:
            with span("sd.binarize.wait"):
                bits = download(packed)
            with span("sd.binarize.unpack"):
                masks = np.unpackbits(bits, axis=-1)[:, :, :plan.img_width]
                for j, i in enumerate(chunk):
                    out[i] = (masks[j] * 255).astype(np.uint8)[:, :, None]

    def binarize_image(self, image: np.ndarray) -> np.ndarray:
        """(H0, W0, C) uint8 -> (height, W_rs, 1) uint8 in {0, 255}; with
        ``fused``, through the batched fused program as a batch of one
        (where the JAX package's fused single-image program uploads the
        three-channel line and downloads the byte mask, this uploads an
        achromatic line as one channel and downloads the mask's bits)."""
        if self.fused:
            return self.binarize_images([image])[0]
        tiles, plan = self.preprocess_image(image)
        return self.postprocess_stack(self.binarize_tiles(tiles), plan)

    def binarize_images(self, images) -> list[np.ndarray]:
        """Every image's mask, as :meth:`binarize_image` gives it, with the
        work batched across images: width groups of at least
        ``config.fused_batch_min`` images (every group when ``fused``) go
        through the batched fused program, the rest through one bucketed
        tile batch."""
        with span("sd.binarize"):
            return self._binarize_images(images)

    def _binarize_images(self, images) -> list[np.ndarray]:
        cfg = self.config
        if not len(images):
            return []
        # Resized widths from the shapes alone, with the int-truncating
        # ratio of resize_to_height_np; the resize itself happens per chunk.
        plans = []
        for image in images:
            h, w = np.asarray(image).shape[:2]
            rs_w = w if h == cfg.height else int(w * (cfg.height / h))
            plans.append(plan_tiles(rs_w, cfg.width, cfg.overlap))
        counts_by_plan: dict[TilePlan, int] = {}
        for plan in plans:
            counts_by_plan[plan] = counts_by_plan.get(plan, 0) + 1
        fmin = cfg.fused_batch_min if not self.fused else 1
        fused_i = [i for i, plan in enumerate(plans)
                   if fmin > 0 and counts_by_plan[plan] >= fmin]
        out: list[np.ndarray | None] = [None] * len(images)
        if fused_i:
            self._binarize_images_fused(images, plans, fused_i, out)
        rest = [i for i in range(len(images)) if out[i] is None]
        if rest:
            with span("sd.binarize.prep"):
                all_tiles = [cut_tiles_np(_prep_line(images[i], cfg),
                                          plans[i]) for i in rest]
                tiles_u8 = np.concatenate(all_tiles, axis=0)
            masks = self.binarize_tiles(tiles_u8)
            with span("sd.binarize.unpack"):
                ofs = 0
                for i, tiles in zip(rest, all_tiles):
                    n = tiles.shape[0]
                    out[i] = stitch_tiles_np(masks[ofs:ofs + n], plans[i])
                    ofs += n
        return out  # type: ignore[return-value]

    def preprocess_image(self, image: np.ndarray):
        """Resize to height and cut into padded tiles -> (tiles, plan)."""
        cfg = self.config
        img_rs = _prep_line(image, cfg)
        plan = plan_tiles(img_rs.shape[1], cfg.width, cfg.overlap)
        return cut_tiles_np(img_rs, plan), plan

    def postprocess_stack(self, masks: np.ndarray, plan: TilePlan) -> np.ndarray:
        return stitch_tiles_np(masks, plan)

"""Stroke estimation: mask -> glyph groups -> crops -> encoder (a ResNet or
a ViT, ``models.encoder.make_encoder``) ->
fused greedy (K1) or beam (K2) decode -> strokes.

Counterpart of ``StrokeEstimator.process_image`` and ``process_images`` of
the JAX ``pipeline/strokes.py``. With ``device_partition`` on (the
default) the host ships a group-id image, packed as the JAX package packs
it (``ops.device_partition.pack_gid``), with the plan in one copy, and the
crops are built on the device; with it off (``--host-partition``)
:func:`compute_partitions` builds them on the host, as training data is
built, and the uint8 crops are uploaded.
``process_images`` runs the glyphs of every image through one crop gather,
one encoder call and one decode launch (per ``config.io_chunks`` chunk).
With ``redecode_coverage`` > 0, ink that the strokes leave uncovered is
decoded again in up to ``redecode_passes`` residual passes (each pass of
``process_images`` one gather, one encoder call and one launch per chunk
over the residuals of every image still short of the floor), and with
``refine_snap`` > 0 the strokes are snapped onto the ink. The JAX package
pads the glyph batch to ``glyph_bucket`` rows to bound recompiles. Without
int8, rows are independent at every stage, so the port runs the real rows
only and the output is the same. Under ``quant="int8"`` the encoder's
activation scale spans the whole batch, so a row's features depend on the
rows beside it: the port then pads the encoder's batch with the blank
crops that the JAX package pads it with, to a multiple of
``glyph_bucket``, over the same chunks, and decodes the real rows only.

With a ``mesh`` (``parallel.mesh``) every rank runs this same code on the
same masks: the parameters are replicated, the glyph rows are dealt over
the dp ranks (each rank builds the crops of its own rows, encodes them
and decodes them with one K1 or K2 launch, and the tokens are gathered in
order), and the batch is padded as the JAX package pads a sharded batch:
to a multiple of dp, and under int8 to lcm(``glyph_bucket``, dp) with
blank crops, the activation scale then spanning every rank's rows. The
rows are dealt round-robin in order of decreasing ink, so that each rank
gets as many long glyphs as the others; rows are independent (under int8
the scale is the max over the whole padded batch, wherever its rows lie),
so the deal changes no output.

While a profile records (``utils.profiling``), ``process_images`` is the
span ``sd.strokes``; inside it ``components`` and ``grouping`` (the host
plan, per image, then the packed group-id stack per chunk), ``gather``
(the upload and the crop gather), ``encode`` (normalization, encoder,
projection; for a ViT, ``encode.vit`` around its forward and the counter
``encoder_tokens``, the rows of its batch x its tokens), ``decode`` (the
decode launch and what it needs),
``wait`` (the tokens' download), ``polylines`` (tokens to strokes, per
image); a residual pass's spans, where on, lie inside ``sd.strokes`` as
the first pass's do.
"""

from __future__ import annotations

import numpy as np
import torch

from stroke_derenderer_tpu_torch.config import StrokesConfig
from stroke_derenderer_tpu_torch.data.synthetic import rasterize_strokes
from stroke_derenderer_tpu_torch.device import dtype_of, resolve_device
from stroke_derenderer_tpu_torch.kernels.fused_beam import (
    fused_beam_decode, fused_beam_decode_sharded,
)
from stroke_derenderer_tpu_torch.kernels.fused_decode import (
    fused_greedy_decode, fused_greedy_decode_sharded,
)
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
from stroke_derenderer_tpu_torch.models.encoder import (
    encode_postprocess, make_encoder,
)
from stroke_derenderer_tpu_torch.models.layers import linear
from stroke_derenderer_tpu_torch.models.vit import ViTEncoder
from stroke_derenderer_tpu_torch.ops import grouping
from stroke_derenderer_tpu_torch.ops.device_partition import (
    PartitionPlan, gather_crops, gather_crops_batched, pack_gid,
    plan_partitions,
)
from stroke_derenderer_tpu_torch.ops.normalize import (
    imagenet_normalize_np, minmax_normalize_np,
)
from stroke_derenderer_tpu_torch.ops.strokes import (
    decode_tokens_batch, merge_stroke_fragments, refine_strokes,
    sort_strokes,
)
from stroke_derenderer_tpu_torch.parallel.mesh import padded_batch, spmd
from stroke_derenderer_tpu_torch.utils.profiling import (
    COUNTERS, download, span, upload,
)
from stroke_derenderer_tpu_torch.weights import (
    encoder_state, from_flax_decoder, from_flax_projection, init_projection,
    init_strokes, read_msgpack,
)


def residual_ink(mask: np.ndarray, strokes, tol: int = 2,
                 min_px: int = 16) -> np.ndarray | None:
    """Ink of ``mask`` (bool, (h, w)) not within ~``tol`` px of any of the
    polylines, without the 8-connected specks of fewer than ``min_px``
    pixels (they decode to noise, not strokes); None when nothing is left."""
    from scipy import ndimage

    if strokes:
        cov = rasterize_strokes(strokes, mask.shape,
                                thickness=tol + 1).astype(bool)
        resid = mask & ~cov
    else:
        resid = mask
    if not resid.any():
        return None
    lab, n = ndimage.label(resid, structure=np.ones((3, 3), bool))
    if n == 0:
        return None
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    resid = (sizes >= min_px)[lab]
    return resid if resid.any() else None


def _packed_arg(up: list, k: int):
    """The first ``k`` uploaded tensors as ``unpack_gid`` takes them: one
    tensor, or the (starts, vals) pair of a run-length packing."""
    return up[0] if k == 1 else tuple(up[:k])


def normalize_crops(x: torch.Tensor, mean, std,
                    rint: bool = False) -> torch.Tensor:
    """(N, H, W) float32 crops in 0..255 -> normalized (N, H, W, 3): per-crop
    min-max rescale to 0..255 (rounded and clipped as a uint8 round trip
    would with ``rint``), then ImageNet mean/std."""
    mean = torch.tensor(mean, device=x.device)
    std = torch.tensor(std, device=x.device)
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    x = torch.where(mx > mn,
                    (x - mn) * (255.0 / torch.clamp(mx - mn, min=1e-12)),
                    torch.zeros_like(x))
    if rint:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return (x[..., None] / 255.0 - mean) / std


def compute_partitions(img_bin: np.ndarray, cfg: StrokesConfig) -> list[dict]:
    """The host partition of a binarized (H, W) image: islands grouped to
    the line height, each group min-max normalized, resized and padded into
    the crop, and its transforms. Used by the ``--host-partition`` path and
    by the training data, so that training crops are inference crops."""
    img_bin = np.asarray(img_bin)
    if img_bin.ndim == 3:
        img_bin = img_bin[:, :, 0]
    islands = grouping.get_binarized_islands(img_bin.astype(np.uint8),
                                             margin=cfg.margin)
    if not islands:
        return []
    img_h = img_bin.shape[0]
    partitions = []
    for canvas, (top, left) in grouping.group_islands(islands,
                                                      (img_h, img_h)):
        padded, ratio, (x2, y2) = grouping.resize_and_pad_np(
            minmax_normalize_np(canvas), cfg.tgt_shape, margin=1,
            pad_value=0)
        partitions.append({
            "image": padded,                      # (S, S) uint8
            "image_input": imagenet_normalize_np(
                minmax_normalize_np(padded), cfg.mean, cfg.std),
            "translate1": (left, top),            # (x, y)
            "ratio": ratio,
            "translate2": (x2, y2),               # (x, y)
        })
    return partitions


class StrokeEstimator:
    def __init__(self, config: StrokesConfig,
                 weights_paths: dict | None = None, device=None,
                 variables: tuple | None = None, mesh=None):
        """``weights_paths``: {"encoder": path, "decoder": path} to the
        networks' flax msgpack files, and "projection" to the projection
        head's where ``config.projection_dim`` > 0; ``variables``: the
        (encoder, decoder, projection or None) flax trees given in memory
        instead, as an ONNX import gives them; with neither, random weights
        (``weights.init_strokes``, seed 0). ``config.encoder_arch`` names a
        ResNet or a ViT (``models.encoder.make_encoder``, which raises a
        ``ValueError`` for a ViT under int8 or at an ``encode_image_size``
        that is not ``image_size // patch``); a ResNet's
        ``config.encoder_norm`` is ``"group"`` or ``"batch"``;
        ``config.quant`` ``"int8"`` runs a ResNet's int8 conv stacks
        (``ops.quant``). ``mesh``: this rank's
        ``parallel.mesh.Mesh``; the pipeline then runs on the mesh's device
        (``device`` is not read)."""
        self.config = cfg = config
        if cfg.decode not in ("greedy", "beam"):
            raise ValueError(f"decode must be 'greedy' or 'beam', got "
                             f"{cfg.decode!r}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        dtype = dtype_of(cfg.compute_dtype)
        if variables is None and weights_paths is not None:
            if cfg.projection_dim and "projection" not in weights_paths:
                raise ValueError(
                    f"projection_dim={cfg.projection_dim} but no projection "
                    "weights (strokes_projection.msgpack) were given")
            variables = tuple(
                read_msgpack(weights_paths[k]) if k in weights_paths
                else None for k in ("encoder", "decoder", "projection"))
        if variables is None:
            encoder, decoder = init_strokes(cfg)
            projection = init_projection(cfg)
        else:
            enc_vars, dec_vars, proj_vars = variables
            encoder = make_encoder(cfg, dtype)
            decoder = AttentiveDecoder(
                cfg.vocab_size, cfg.embed_dim, cfg.attention_dim,
                cfg.decoder_dim, cfg.projection_dim or encoder.out_features,
                dtype=dtype)
            encoder.load_state_dict(encoder_state(enc_vars,
                                                  cfg.encoder_arch))
            decoder.load_state_dict(from_flax_decoder(dec_vars))
            projection = None
            if cfg.projection_dim:
                projection = torch.nn.Linear(encoder.out_features,
                                             cfg.projection_dim)
                projection.load_state_dict(from_flax_projection(proj_vars))
        self.encoder = encoder.to(self.device).eval()
        self.decoder = decoder.to(self.device).eval()
        self.projection = (None if projection is None
                           else projection.to(self.device).eval())
        self.compute_dtype = dtype
        if self.device.type == "cuda":
            # Build (or load) the decode kernel now, not in the first call.
            from stroke_derenderer_tpu_torch.kernels.build import load_library
            load_library("fused_beam" if cfg.decode == "beam"
                         else "fused_decode", deps=("decode_step.cuh",))

    def _normalize_raw(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W) float32 crops in 0..255 -> normalized (N, H, W, 3):
        per-crop min-max rescale, then ImageNet mean/std."""
        return normalize_crops(x, self.config.mean, self.config.std)

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized crops -> the encoder's (rows, P, C) sequence. A ViT
        runs in the span ``sd.strokes.encode.vit`` and counts its tokens,
        from shapes alone, as ``encoder_tokens``."""
        if not isinstance(self.encoder, ViTEncoder):
            return encode_postprocess(self.encoder(images),
                                      self.config.encode_image_size)
        with span("sd.strokes.encode.vit"):
            COUNTERS.add("encoder_tokens",
                         images.shape[0] * self.encoder.tokens)
            return self.encoder(images)

    @torch.inference_mode()
    def _encode_and_decode(self, crops: torch.Tensor,
                           max_length: int | None,
                           batch: int | None = None) -> torch.Tensor:
        """(N, S, S) float32 crops in 0..255 on the device -> (N,
        max_length) int32 tokens there: normalization, encoder, projection
        head (where there is one), one K1 (greedy) or K2 (beam) call. Under
        int8 the encoder sees the batch padded with blank crops to a
        multiple of ``glyph_bucket`` (the JAX package's batch); only the N
        real rows are decoded.

        Under the mesh, ``crops`` are this rank's rows of a padded global
        batch of ``batch`` rows (at most ``batch // dp``; under int8 the
        encoder sees exactly that many, blank crops last), and the result
        is the (batch, max_length) tokens of every rank, gathered over dp
        (:func:`fused_greedy_decode_sharded`), PAD in the pad rows."""
        cfg = self.config
        n = crops.shape[0]
        mesh = self.mesh if batch is not None else None
        rows = n
        if cfg.quant != "none":
            rows = (batch // mesh.shape["dp"] if mesh is not None
                    else -(-n // cfg.glyph_bucket) * cfg.glyph_bucket)
        with span("sd.strokes.encode"):
            if rows > n:
                crops = torch.cat([crops, crops.new_zeros((rows - n,)
                                                          + crops.shape[1:])])
            if rows == 0:  # a rank without rows of its own
                seq = torch.zeros((0, cfg.encode_image_size ** 2,
                                   self.decoder.enc_att_w.shape[0]),
                                  device=self.device)
            else:
                with spmd(mesh):
                    seq = self._encode(self._normalize_raw(crops))[:n]
            if self.projection is not None and n:
                seq = linear(seq.to(self.compute_dtype), self.projection)
            seq = seq.to(self.compute_dtype)
        max_length = max_length or cfg.max_length
        with span("sd.strokes.decode"):
            if mesh is not None:
                if cfg.decode == "beam":
                    return fused_beam_decode_sharded(
                        self.decoder, seq, max_length, mesh, batch,
                        cfg.beam_size, cfg.length_penalty)
                return fused_greedy_decode_sharded(self.decoder, seq,
                                                   max_length, mesh, batch)
            if cfg.decode == "beam":
                return fused_beam_decode(self.decoder, seq, max_length,
                                         cfg.beam_size, cfg.length_penalty)
            return fused_greedy_decode(self.decoder, seq, max_length)

    def _sharded_tokens(self, n: int, crops_of, max_length: int | None,
                        order=None) -> torch.Tensor:
        """The (n, max_length) tokens of n glyph rows under the mesh, on
        the device: ``crops_of(idx)`` builds the crops of the rows ``idx``
        (a numpy index array) on the device. The rows, in ``order``
        (default their own), are dealt round-robin over the dp ranks; each
        rank encodes and decodes its own, and the gathered tokens are put
        back in row order."""
        cfg = self.config
        dp = self.mesh.shape["dp"]
        order = np.arange(n) if order is None else np.asarray(order)
        batch = padded_batch(n, cfg.glyph_bucket if cfg.quant != "none"
                             else 1, dp)
        local = batch // dp
        tokens = self._encode_and_decode(
            crops_of(order[self.mesh.dp_index::dp]), max_length, batch)
        pos = np.empty(n, np.int64)
        for k in range(dp):
            rows = order[k::dp]
            pos[rows] = k * local + np.arange(len(rows))
        return tokens[upload(tokens.device, pos)[0]]

    def _packed_gid(self, gid: np.ndarray, max_groups: int):
        """A group-id image or stack, its width padded with -1 to a
        multiple of 256 as the JAX package pads it (even, as the nibble
        packing needs), packed by ``pack_gid`` -> (list of arrays, fmt)."""
        w = gid.shape[-1]
        wb = -(-w // 256) * 256
        if wb != w:
            padded = np.full(gid.shape[:-1] + (wb,), -1, np.int16)
            padded[..., :w] = gid
            gid = padded
        packed, fmt = pack_gid(gid, max_groups,
                               allow_rle=self.config.gid_rle)
        return (list(packed) if fmt.startswith("rle:") else [packed]), fmt

    @staticmethod
    def _tokens_down(tokens: torch.Tensor) -> np.ndarray:
        """Tokens on the device -> int32 on the host, downloaded as int16
        (the vocabulary fits; half the bytes, as the JAX package downloads
        its device-partition tokens; its batched path also downloads its
        ``glyph_bucket`` pad rows, the port only the real ones)."""
        with span("sd.strokes.wait"):
            return download(tokens.to(torch.int16)).astype(np.int32)

    @torch.inference_mode()
    def estimate_tokens(self, plan: PartitionPlan,
                        max_length: int | None = None) -> np.ndarray:
        """One image's partition plan -> (N, max_length) int32 tokens. The
        packed group-id image and the coordinates go up in one copy (the
        JAX package pads the coordinates to ``glyph_bucket`` rows first,
        for its compile cache; the port sends the N real rows)."""
        n = len(plan.partitions)
        coords = [getattr(plan, k) for k in PartitionPlan.COORD_KEYS]
        if self.mesh is None:
            gid, fmt = self._packed_gid(plan.gid_img, n)
            up = upload(self.device, *gid, *coords)
            crops = gather_crops(_packed_arg(up, len(gid)),
                                 tuple(up[len(gid):]), fmt)
            return self._tokens_down(self._encode_and_decode(crops,
                                                             max_length))
        gid, fmt = self._packed_gid(plan.gid_img[None], n)  # a stack of one

        def crops_of(idx):  # the crops of groups ``idx`` of this image
            k = len(gid)
            up = upload(self.device, *gid, idx.astype(np.int32),
                        *(c[idx] for c in coords))
            return gather_crops_batched(
                _packed_arg(up, k), torch.zeros_like(up[k]), up[k],
                tuple(up[k + 1:]), fmt)

        return self._tokens_down(self._sharded_tokens(n, crops_of,
                                                      max_length))

    def _plan_batch(self, imgs_bin):
        """Plan a set of images for one crop gather: (plans, counts, rows)
        with ``rows`` None when no image has glyphs, else the group-id
        images stacked (padded with -1), packed, under "gid" (a list of
        arrays) and "gid_fmt", and, for every glyph
        row in image order, its image ("img_idx"), its image-local id
        ("local_id"), its ink and its ``PartitionPlan.COORD_KEYS``."""
        cfg = self.config
        masks = [np.asarray(m) for m in imgs_bin]
        masks = [m[:, :, 0] if m.ndim == 3 else m for m in masks]
        plans = [plan_partitions(m, cfg.margin, cfg.image_size)
                 for m in masks]
        counts = [len(p.partitions) if p else 0 for p in plans]
        if sum(counts) == 0:
            return plans, counts, None
        with span("sd.strokes.grouping"):
            return plans, counts, self._stack_plans(masks, plans, counts)

    def _stack_plans(self, masks, plans, counts) -> dict:
        """:meth:`_plan_batch`'s ``rows`` from the images' plans."""
        # Width to a multiple of 256 here, so that _packed_gid pads nothing.
        gid_stack = np.full((len(masks), max(m.shape[0] for m in masks),
                             -(-max(m.shape[1] for m in masks) // 256) * 256),
                            -1, np.int16)
        for i, (m, p) in enumerate(zip(masks, plans)):
            if p is not None:
                gid_stack[i, :m.shape[0], :m.shape[1]] = p.gid_img
        live = [(i, p) for i, p in enumerate(plans) if p is not None]
        gid, fmt = self._packed_gid(gid_stack, max(counts))
        rows = {"gid": gid, "gid_fmt": fmt,
                "img_idx": np.concatenate([np.full(counts[i], i, np.int32)
                                           for i, _ in live]),
                "local_id": np.concatenate([np.arange(counts[i],
                                                      dtype=np.int32)
                                            for i, _ in live]),
                "ink": np.concatenate([p.ink for _, p in live])}
        for k in PartitionPlan.COORD_KEYS:
            rows[k] = np.concatenate([getattr(p, k) for _, p in live])
        return rows

    def _batch_crops(self, rows: dict, idx):
        """The crops of the glyph rows ``idx`` of :meth:`_plan_batch`'s
        ``rows``, in one gather on the device; the packed stack and the
        rows' arrays go up in one copy (the JAX package pads the rows to
        ``glyph_bucket`` first, for its compile cache; the port sends the
        real rows)."""
        k = len(rows["gid"])
        with span("sd.strokes.gather"):
            up = upload(self.device, *rows["gid"], rows["img_idx"][idx],
                        rows["local_id"][idx],
                        *(rows[c][idx] for c in PartitionPlan.COORD_KEYS))
            return gather_crops_batched(_packed_arg(up, k), up[k], up[k + 1],
                                        tuple(up[k + 2:]), rows["gid_fmt"])

    @torch.inference_mode()
    def _gather_batch(self, imgs_bin):
        """Plan a set of images and build all their glyph crops on the
        device in one gather: the group-id images stacked (padded with -1),
        each glyph row's image and image-local id, the rows in order of
        decreasing ink (``perm``; ``inv`` undoes it). Returns (crops or
        None when no image has glyphs, inv, plans, counts)."""
        plans, counts, rows = self._plan_batch(imgs_bin)
        if rows is None:
            return None, None, plans, counts
        # Rows by decreasing ink, as the JAX path orders them for its
        # kernel's per-block early exit; rows are independent, so the
        # order changes no output, and ``inv`` restores it.
        perm = np.argsort(-rows["ink"], kind="stable")
        inv = np.argsort(perm)
        return self._batch_crops(rows, perm), inv, plans, counts

    def process_tokens(self, tokens: np.ndarray, partitions: list[dict]):
        """Token matrix + partition transforms -> globally sorted strokes
        (the span ``sd.strokes.polylines``)."""
        cfg = self.config
        n = min(tokens.shape[0], len(partitions))
        if n == 0:
            return []
        with span("sd.strokes.polylines"):
            per_glyph = decode_tokens_batch(
                np.asarray(tokens[:n]), cfg.image_size, cfg.tgt_shape,
                np.asarray([partitions[i]["translate1"] for i in range(n)]),
                np.asarray([partitions[i]["ratio"] for i in range(n)]),
                np.asarray([partitions[i]["translate2"] for i in range(n)]))
            return sort_strokes([s for glyph in per_glyph for s in glyph])

    def _host_crops(self, partitions: list[dict]) -> torch.Tensor:
        """The host partitions' uint8 crops on the device as float32 (the
        JAX package also uploads its ``glyph_bucket`` pad crops)."""
        if not partitions:
            s = self.config.image_size
            return torch.zeros((0, s, s), device=self.device)
        crops = np.stack([p["image"] for p in partitions]).astype(np.uint8)
        return upload(self.device, crops)[0].float()

    def _host_tokens(self, partitions: list[dict], max_length):
        """Tokens of the host partitions' crops, on the device."""
        if self.mesh is not None:
            return self._sharded_tokens(
                len(partitions), lambda idx: self._host_crops(
                    [partitions[i] for i in idx]), max_length)
        return self._encode_and_decode(self._host_crops(partitions),
                                       max_length)

    def _process_image_once(self, img_bin, max_length: int | None):
        if not self.config.device_partition:
            partitions = compute_partitions(img_bin, self.config)
            if not partitions:
                return []
            preds = download(self._host_tokens(partitions, max_length))
            return self.process_tokens(preds, partitions)
        plan = plan_partitions(np.asarray(img_bin), self.config.margin,
                               self.config.image_size)
        if plan is None:
            return []
        return self.process_tokens(self.estimate_tokens(plan, max_length),
                                   plan.partitions)

    def _process_images_once(self, imgs_bin, max_length: int | None):
        """One pass over every image: the glyphs of all of them in one crop
        gather, one encoder call and one decode launch per
        ``config.io_chunks`` chunk, every chunk queued on the device before
        the first tokens are downloaded."""
        imgs_bin = list(imgs_bin)
        if not self.config.device_partition:
            return self._process_images_host(imgs_bin, max_length)
        nch = max(1, -(-len(imgs_bin) // self.config.io_chunks))
        pending = []
        for c0 in range(0, len(imgs_bin), nch):
            if self.mesh is not None:
                pending.append(self._dispatch_sharded(imgs_bin[c0:c0 + nch],
                                                      max_length))
                continue
            crops, inv, plans, counts = self._gather_batch(
                imgs_bin[c0:c0 + nch])
            preds = None if crops is None else self._encode_and_decode(
                crops, max_length)
            pending.append((preds, inv, plans, counts))
        out = []
        for preds, inv, plans, counts in pending:
            if preds is not None:
                preds = self._tokens_down(preds)
                preds = preds if inv is None else preds[inv]
            ofs = 0
            for p, n in zip(plans, counts):
                out.append(self.process_tokens(preds[ofs:ofs + n],
                                               p.partitions) if n else [])
                ofs += n
        return out

    def _dispatch_sharded(self, imgs_bin, max_length: int | None):
        """One chunk of :meth:`_process_images_once` under the mesh: (tokens
        in image order or None, None, plans, counts), the rows dealt in
        order of decreasing ink."""
        plans, counts, rows = self._plan_batch(imgs_bin)
        if rows is None:
            return None, None, plans, counts
        preds = self._sharded_tokens(
            sum(counts), lambda idx: self._batch_crops(rows, idx),
            max_length, np.argsort(-rows["ink"], kind="stable"))
        return preds, None, plans, counts

    def _process_images_host(self, imgs_bin, max_length: int | None):
        """:meth:`_process_images_once` on the host partitions: every
        image's crops in one upload, one encoder call and one decode
        launch."""
        all_parts = [compute_partitions(m, self.config) for m in imgs_bin]
        counts = [len(p) for p in all_parts]
        if sum(counts) == 0:
            return [[] for _ in imgs_bin]
        preds = download(self._host_tokens(
            [p for parts in all_parts for p in parts], max_length))
        out, ofs = [], 0
        for parts, n in zip(all_parts, counts):
            out.append(self.process_tokens(preds[ofs:ofs + n], parts)
                       if n else [])
            ofs += n
        return out

    def _residual_for(self, img_bin, strokes):
        """The residual ink mask while the strokes cover less than
        ``redecode_coverage`` of the ink, else None."""
        cfg = self.config
        mask = np.asarray(img_bin)
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        mask = mask.astype(bool)
        ink = int(mask.sum())
        if ink == 0:
            return None
        resid = residual_ink(mask, strokes, tol=cfg.redecode_tol)
        if resid is None or 1.0 - resid.sum() / ink >= cfg.redecode_coverage:
            return None
        return resid

    def _merge_redecoded(self, strokes, extra):
        """Base and residual strokes joined where endpoints lie within
        max(``redecode_join_tol``, 2 * ``redecode_tol`` + 2) px, then
        re-sorted into writing order."""
        if not extra:
            return strokes
        merged = merge_stroke_fragments(
            strokes + extra,
            tol=max(self.config.redecode_join_tol,
                    2.0 * self.config.redecode_tol + 2))
        return sort_strokes(merged)

    def _refine(self, strokes, img_bin):
        """Ink-snap refinement within ``refine_snap`` px (0 = off), then
        re-sorted: snapping can move the endpoints the sort keys on."""
        if self.config.refine_snap <= 0 or not strokes:
            return strokes
        return sort_strokes(refine_strokes(strokes, np.asarray(img_bin),
                                           self.config.refine_snap))

    def process_image(self, img_bin: np.ndarray, max_length: int | None = None):
        """Binarized (H, W) image -> strokes in its coordinate frame. With
        ``redecode_coverage`` > 0, still-uncovered ink gets up to
        ``redecode_passes`` residual passes, each merged and re-sorted,
        until the coverage floor is met or a pass decodes nothing."""
        strokes = self._process_image_once(img_bin, max_length)
        if self.config.redecode_coverage > 0:
            for _ in range(max(self.config.redecode_passes, 1)):
                resid = self._residual_for(img_bin, strokes)
                if resid is None:
                    break
                extra = self._process_image_once(resid, max_length)
                if not extra:  # the residual would not shrink
                    break
                strokes = self._merge_redecoded(strokes, extra)
        return self._refine(strokes, img_bin)

    def process_images(self, imgs_bin, max_length: int | None = None):
        """Binarized (H, W) images -> one stroke list per image, as
        :meth:`process_image` gives it (an image without glyphs gets []).
        Each pass, the first and every residual one, is one
        :meth:`_process_images_once` over the images still in it; an image
        whose residual pass decoded nothing leaves the loop."""
        with span("sd.strokes"):
            return self._process_images(imgs_bin, max_length)

    def _process_images(self, imgs_bin, max_length: int | None = None):
        imgs_bin = list(imgs_bin)
        out = self._process_images_once(imgs_bin, max_length)
        if self.config.redecode_coverage > 0:
            live = list(range(len(out)))
            for _ in range(max(self.config.redecode_passes, 1)):
                resids = {i: self._residual_for(imgs_bin[i], out[i])
                          for i in live}
                todo = [i for i in live if resids[i] is not None]
                if not todo:
                    break
                extras = self._process_images_once(
                    [resids[i] for i in todo], max_length)
                live = []
                for i, extra in zip(todo, extras):
                    if extra:
                        out[i] = self._merge_redecoded(out[i], extra)
                        live.append(i)
        if self.config.refine_snap > 0:
            out = [self._refine(s, m) for s, m in zip(out, imgs_bin)]
        return out

"""Stroke estimation on the device-partition path: mask -> glyph groups ->
crops on the device -> ResNet encoder -> fused greedy (K1) or beam (K2)
decode -> strokes.

Counterpart of ``StrokeEstimator.process_image`` and ``process_images`` of
the JAX ``pipeline/strokes.py`` with ``device_partition`` on and no
re-decode or refinement (the shipped configuration). ``process_images``
runs the glyphs of every image through one crop gather, one encoder call
and one decode launch (per ``config.io_chunks`` chunk). The JAX package
pads the glyph batch to ``glyph_bucket`` rows to bound recompiles; rows are
independent at every stage, so the port runs the real rows only and the
output is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from stroke_derenderer_tpu_torch.config import StrokesConfig
from stroke_derenderer_tpu_torch.device import dtype_of, resolve_device
from stroke_derenderer_tpu_torch.kernels.fused_beam import fused_beam_decode
from stroke_derenderer_tpu_torch.kernels.fused_decode import (
    fused_greedy_decode,
)
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
from stroke_derenderer_tpu_torch.models.encoder import (
    ARCHS, ResNetEncoder, encode_postprocess,
)
from stroke_derenderer_tpu_torch.ops.device_partition import (
    PartitionPlan, gather_crops, gather_crops_batched, plan_partitions,
)
from stroke_derenderer_tpu_torch.ops.strokes import (
    decode_tokens_batch, sort_strokes,
)
from stroke_derenderer_tpu_torch.weights import (
    from_flax_decoder, from_flax_encoder, read_msgpack,
)


class StrokeEstimator:
    def __init__(self, config: StrokesConfig, weights_paths: dict,
                 device=None):
        """``weights_paths``: {"encoder": path, "decoder": path} to the
        networks' flax msgpack files."""
        self.config = cfg = config
        if cfg.decode not in ("greedy", "beam"):
            raise ValueError(f"decode must be 'greedy' or 'beam', got "
                             f"{cfg.decode!r}")
        unsupported = [name for name, bad in (
            ("projection_dim", cfg.projection_dim != 0),
            ("encoder_norm", cfg.encoder_norm != "group"),
            ("redecode_coverage", cfg.redecode_coverage > 0),
            ("refine_snap", cfg.refine_snap > 0),
            ("quant", cfg.quant != "none"),
            ("device_partition", not cfg.device_partition)) if bad]
        if unsupported:
            raise NotImplementedError(
                f"not ported yet (ROADMAP.md): {unsupported}")
        self.device = resolve_device(device)
        dtype = dtype_of(cfg.compute_dtype)
        encoder = ResNetEncoder(cfg.encoder_arch, dtype=dtype)
        decoder = AttentiveDecoder(
            cfg.vocab_size, cfg.embed_dim, cfg.attention_dim,
            cfg.decoder_dim, encoder.out_features, dtype=dtype)
        encoder.load_state_dict(from_flax_encoder(
            read_msgpack(weights_paths["encoder"]), ARCHS[cfg.encoder_arch][0]))
        decoder.load_state_dict(from_flax_decoder(
            read_msgpack(weights_paths["decoder"])))
        self.encoder = encoder.to(self.device).eval()
        self.decoder = decoder.to(self.device).eval()
        self.compute_dtype = dtype
        if self.device.type == "cuda":
            # Build (or load) the decode kernel now, not in the first call.
            from stroke_derenderer_tpu_torch.kernels.build import load_library
            load_library("fused_beam" if cfg.decode == "beam"
                         else "fused_decode", deps=("decode_step.cuh",))

    def _normalize_raw(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W) float32 crops in 0..255 -> normalized (N, H, W, 3):
        per-crop min-max rescale, then ImageNet mean/std."""
        mean = torch.tensor(self.config.mean, device=x.device)
        std = torch.tensor(self.config.std, device=x.device)
        mn = x.amin(dim=(1, 2), keepdim=True)
        mx = x.amax(dim=(1, 2), keepdim=True)
        x = torch.where(mx > mn,
                        (x - mn) * (255.0 / torch.clamp(mx - mn, min=1e-12)),
                        torch.zeros_like(x))
        return (x[..., None] / 255.0 - mean) / std

    @torch.inference_mode()
    def _encode_and_decode(self, crops: torch.Tensor,
                           max_length: int | None) -> torch.Tensor:
        """(N, S, S) float32 crops in 0..255 on the device -> (N,
        max_length) int32 tokens there: normalization, encoder, one K1
        (greedy) or K2 (beam) call."""
        cfg = self.config
        images = self._normalize_raw(crops)
        seq = encode_postprocess(self.encoder(images), cfg.encode_image_size)
        seq = seq.to(self.compute_dtype)
        max_length = max_length or cfg.max_length
        if cfg.decode == "beam":
            return fused_beam_decode(self.decoder, seq, max_length,
                                     cfg.beam_size, cfg.length_penalty)
        return fused_greedy_decode(self.decoder, seq, max_length)

    @torch.inference_mode()
    def estimate_tokens(self, plan: PartitionPlan,
                        max_length: int | None = None) -> np.ndarray:
        """One image's partition plan -> (N, max_length) int32 tokens."""
        coords = tuple(torch.from_numpy(np.ascontiguousarray(
            getattr(plan, k))).to(self.device)
            for k in PartitionPlan.COORD_KEYS)
        crops = gather_crops(torch.from_numpy(plan.gid_img).to(self.device),
                             coords)
        return self._encode_and_decode(crops, max_length).cpu().numpy()

    @torch.inference_mode()
    def _gather_batch(self, imgs_bin):
        """Plan a set of images and build all their glyph crops on the
        device in one gather: the group-id images stacked (padded with -1),
        each glyph row's image and image-local id, the rows in order of
        decreasing ink (``perm``; ``inv`` undoes it). Returns (crops or
        None when no image has glyphs, inv, plans, counts)."""
        cfg = self.config
        masks = [np.asarray(m) for m in imgs_bin]
        masks = [m[:, :, 0] if m.ndim == 3 else m for m in masks]
        plans = [plan_partitions(m, cfg.margin, cfg.image_size)
                 for m in masks]
        counts = [len(p.partitions) if p else 0 for p in plans]
        if sum(counts) == 0:
            return None, None, plans, counts
        gid_stack = np.full((len(masks), max(m.shape[0] for m in masks),
                             max(m.shape[1] for m in masks)), -1, np.int16)
        for i, (m, p) in enumerate(zip(masks, plans)):
            if p is not None:
                gid_stack[i, :m.shape[0], :m.shape[1]] = p.gid_img
        live = [(i, p) for i, p in enumerate(plans) if p is not None]
        img_idx = np.concatenate([np.full(counts[i], i, np.int32)
                                  for i, _ in live])
        local_id = np.concatenate([np.arange(counts[i], dtype=np.int32)
                                   for i, _ in live])
        ink = np.concatenate([p.ink for _, p in live])
        # Rows by decreasing ink, as the JAX path orders them for its
        # kernel's per-block early exit; rows are independent, so the
        # order changes no output, and ``inv`` restores it.
        perm = np.argsort(-ink, kind="stable")
        inv = np.argsort(perm)
        coords = tuple(
            torch.from_numpy(np.concatenate(
                [getattr(p, k) for _, p in live])[perm]).to(self.device)
            for k in PartitionPlan.COORD_KEYS)
        up = lambda a: torch.from_numpy(a).to(self.device)
        crops = gather_crops_batched(up(gid_stack), up(img_idx[perm]),
                                     up(local_id[perm]), coords)
        return crops, inv, plans, counts

    def process_tokens(self, tokens: np.ndarray, partitions: list[dict]):
        """Token matrix + partition transforms -> globally sorted strokes."""
        cfg = self.config
        n = min(tokens.shape[0], len(partitions))
        if n == 0:
            return []
        per_glyph = decode_tokens_batch(
            np.asarray(tokens[:n]), cfg.image_size, cfg.tgt_shape,
            np.asarray([partitions[i]["translate1"] for i in range(n)]),
            np.asarray([partitions[i]["ratio"] for i in range(n)]),
            np.asarray([partitions[i]["translate2"] for i in range(n)]))
        return sort_strokes([s for glyph in per_glyph for s in glyph])

    def process_image(self, img_bin: np.ndarray, max_length: int | None = None):
        """Binarized (H, W) image -> strokes in its coordinate frame."""
        plan = plan_partitions(np.asarray(img_bin), self.config.margin,
                               self.config.image_size)
        if plan is None:
            return []
        return self.process_tokens(self.estimate_tokens(plan, max_length),
                                   plan.partitions)

    def process_images(self, imgs_bin, max_length: int | None = None):
        """Binarized (H, W) images -> one stroke list per image, as
        :meth:`process_image` gives it (an image without glyphs gets []),
        with the glyphs of every image in one crop gather, one encoder call
        and one decode launch per ``config.io_chunks`` chunk. Every chunk is
        queued on the device before the first tokens are downloaded."""
        imgs_bin = list(imgs_bin)
        nch = max(1, -(-len(imgs_bin) // self.config.io_chunks))
        pending = []
        for c0 in range(0, len(imgs_bin), nch):
            crops, inv, plans, counts = self._gather_batch(
                imgs_bin[c0:c0 + nch])
            preds = None if crops is None else self._encode_and_decode(
                crops, max_length)
            pending.append((preds, inv, plans, counts))
        out = []
        for preds, inv, plans, counts in pending:
            if preds is not None:
                preds = preds.cpu().numpy()[inv]
            ofs = 0
            for p, n in zip(plans, counts):
                out.append(self.process_tokens(preds[ofs:ofs + n],
                                               p.partitions) if n else [])
                ofs += n
        return out

"""Stroke estimation on the device-partition path: mask -> glyph groups ->
crops on the device -> ResNet encoder -> fused greedy (K1) or beam (K2)
decode -> strokes.

Counterpart of ``StrokeEstimator.process_image`` of the JAX
``pipeline/strokes.py`` with ``device_partition`` on and no re-decode or
refinement (the shipped configuration). The JAX package pads the glyph
batch to ``glyph_bucket`` rows to bound recompiles; rows are independent at
every stage, so the port runs the real rows only and the output is the same.
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
    PartitionPlan, gather_crops, plan_partitions,
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
    def estimate_tokens(self, plan: PartitionPlan,
                        max_length: int | None = None) -> np.ndarray:
        """One image's partition plan -> (N, max_length) int32 tokens."""
        cfg = self.config
        dev = self.device
        gid = torch.from_numpy(plan.gid_img).to(dev)
        coords = tuple(torch.from_numpy(np.ascontiguousarray(
            getattr(plan, k))).to(dev) for k in PartitionPlan.COORD_KEYS)
        images = self._normalize_raw(gather_crops(gid, coords))
        seq = encode_postprocess(self.encoder(images), cfg.encode_image_size)
        seq = seq.to(self.compute_dtype)
        max_length = max_length or cfg.max_length
        if cfg.decode == "beam":
            tokens = fused_beam_decode(self.decoder, seq, max_length,
                                       cfg.beam_size, cfg.length_penalty)
        else:
            tokens = fused_greedy_decode(self.decoder, seq, max_length)
        return tokens.cpu().numpy()

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

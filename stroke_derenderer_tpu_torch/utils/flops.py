"""FLOPs of the pipelines' networks, the counterpart of the JAX
``utils/flops.py``.

:func:`flops` counts with ``torch.utils.flop_counter.FlopCounterMode``,
PyTorch's own count of the matrix products and convolutions a call runs,
as the JAX package asks XLA's cost analysis (``xla_flops``). The two
counters differ in what they see: XLA also counts elementwise operations
and leaves a convolution's products with its zero padding out; PyTorch
counts only products and sums of matrix products and convolutions, the
padding's included. Neither sees a hand-written kernel, so the decoder's
step is counted on its plain version, as the JAX package counts the plain
flax ``step``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def flops(fn, *args) -> float:
    """FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them. Run on
    tensors of the ``meta`` device, nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def bench_flops_per_image(images: list[np.ndarray], decode_steps: int,
                          bin_config=None, se_config=None) -> dict:
    """Per-image FLOPs of the two pipeline stages at the shapes a batch of
    ``images`` gives them: the UNet over all their tiles, the encoder over
    all their glyph groups (as the host partition cuts them), and
    ``decode_steps`` decoder steps at that batch, with the encoder
    sequence's projection charged once. The configs default to the JAX
    package's defaults, as its function uses; counted on the ``meta``
    device."""
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.device import dtype_of
    from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
    from stroke_derenderer_tpu_torch.models.encoder import make_encoder
    from stroke_derenderer_tpu_torch.models.unet import AttentionUNet
    from stroke_derenderer_tpu_torch.ops.resize import resize_to_height_np
    from stroke_derenderer_tpu_torch.ops.tiling import plan_tiles
    from stroke_derenderer_tpu_torch.pipeline.strokes import (
        compute_partitions,
    )

    meta = torch.device("meta")
    n_images = len(images)
    bin_cfg = bin_config or BinarizerConfig()
    se_cfg = se_config or StrokesConfig()

    # binarize: every tile of every image.
    n_tiles = 0
    masks = []
    for im in images:
        rs = resize_to_height_np(np.asarray(im), bin_cfg.height)
        n_tiles += plan_tiles(rs.shape[1], bin_cfg.width,
                              bin_cfg.overlap).num_tiles
        masks.append((rs[:, :, 0] if rs.ndim == 3 else rs) < 128)
    # strokes: the glyph groups of these images.
    n_glyphs = max(sum(len(compute_partitions(m, se_cfg)) for m in masks), 1)
    with torch.inference_mode(), meta:  # modules and tensors on meta
        unet = AttentionUNet(bin_cfg.features, bin_cfg.bottleneck,
                             bin_cfg.channels,
                             dtype=dtype_of(bin_cfg.compute_dtype),
                             norm=bin_cfg.norm).eval()
        bin_flops = flops(unet, torch.zeros((n_tiles, bin_cfg.height,
                                             bin_cfg.width,
                                             bin_cfg.channels)))
        dtype = dtype_of(se_cfg.compute_dtype)
        encoder = make_encoder(dataclasses.replace(se_cfg, quant="none"),
                               dtype).eval()
        enc_flops = flops(encoder, torch.zeros((n_glyphs, se_cfg.image_size,
                                                se_cfg.image_size, 3)))

        enc_dim = se_cfg.projection_dim or encoder.out_features
        decoder = AttentiveDecoder(se_cfg.vocab_size, se_cfg.embed_dim,
                                   se_cfg.attention_dim, se_cfg.decoder_dim,
                                   enc_dim, dtype=dtype)
        seq = torch.zeros((n_glyphs, se_cfg.encode_image_size ** 2,
                           enc_dim), dtype=dtype)
        emb = torch.zeros((n_glyphs, se_cfg.embed_dim), dtype=dtype)
        h = torch.zeros((n_glyphs, se_cfg.decoder_dim), dtype=dtype)
        proj_flops = flops(decoder.project_encoding, seq)
        step_flops = flops(decoder.step, seq, decoder.project_encoding(seq),
                           emb, h, h)
    strokes_flops = enc_flops + proj_flops + decode_steps * step_flops
    return {
        "binarize_flops_per_image": bin_flops / n_images,
        "strokes_flops_per_image": strokes_flops / n_images,
        "decoder_step_flops": step_flops,
        "n_tiles": n_tiles,
        "n_glyphs": n_glyphs,
    }

"""Native model dir -> the upstream project's five-ONNX-graph layout.

A copy of the JAX package's ``weights/graph_export.py``; for the same model
directory it writes the same bytes. The inverse of :mod:`.graph_import`:
writes ``binarizer.onnx``, ``encoder.onnx``, ``decoder_init_hc.onnx``,
``decoder_embedding.onnx``, ``decoder_iter.onnx`` (+ ``projection.onnx``
when a projection head exists) plus the two config JSONs — the artifact set
the upstream pipeline loads (its ``main.py:43-62``) — from the native
msgpack weights, read with the port's own reader. A model trained here can
therefore be deployed on the upstream ONNX-Runtime stack, and weights
round-trip in both directions.

Graphs are emitted in torch's canonical export patterns (NCHW convs with
OIHW weights, ``Gemm(transB=1)`` 2-D linears, ``MatMul``+``Add`` 3-D
linears, ``Gather`` embeddings, a single iofc-gate ``LSTM`` op) so that
(a) ONNX Runtime executes them like the upstream project's own exports and
(b) :func:`graph_import.import_reference_models` re-imports them
bit-identically (``tests/test_torch_onnx.py`` pins the round trip and runs
the graphs through :mod:`.onnx_run`).

Normalization: ``norm="batch"`` models emit torch-style
``BatchNormalization`` (opset 17); ``norm="group"`` models emit
``GroupNormalization`` with per-channel scale/bias, which is opset-21
semantics (opset 18-20 GN took per-GROUP scale/bias).

I/O tensor names follow the upstream calling code: the binarizer feeds
``{"input": ...}``, decoder_init emits ``output_h``/``output_c``,
decoder_iter takes ``input_enc``/``input_emb``/``input_h``/``input_c`` and
emits ``output_pred``/``output_h``/``output_c``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.weights.onnx_graph import OnnxGraphBuilder


# ---------------------- flax -> torch layout inverses ----------------------


def flax_conv_to_torch(k: np.ndarray) -> np.ndarray:
    """flax Conv kernel (kh, kw, cin, cout) -> torch (cout, cin, kh, kw)."""
    return np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))


def flax_convtranspose_to_torch(k: np.ndarray) -> np.ndarray:
    """Inverse of graph_import.torch_convtranspose_to_flax: flax
    ConvTranspose (kh, kw, cin, cout) -> torch (cin, cout, kh, kw) with the
    spatial flip undone."""
    k = np.asarray(k, np.float32)[::-1, ::-1]
    return np.transpose(k, (2, 3, 0, 1))


def flax_linear_to_torch(k: np.ndarray) -> np.ndarray:
    """flax Dense kernel (in, out) -> torch weight (out, in)."""
    return np.transpose(np.asarray(k, np.float32), (1, 0))


def flax_lstm_to_torch(cell: dict) -> tuple[np.ndarray, ...]:
    """flax nn.LSTMCell per-gate Dense params -> torch packed
    (w_ih (4H,in), w_hh (4H,H), b_ih, b_hh) in torch's ifgo gate order.
    flax keeps the (summed) bias on the hidden-side Dense
    (importer.torch_lstm_to_flax), so b_ih comes back as zeros."""
    gates = ("i", "f", "g", "o")
    w_ih = np.concatenate([flax_linear_to_torch(cell[f"i{g}"]["kernel"])
                           for g in gates], axis=0)
    w_hh = np.concatenate([flax_linear_to_torch(cell[f"h{g}"]["kernel"])
                           for g in gates], axis=0)
    b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32)
                           for g in gates], axis=0)
    return w_ih, w_hh, np.zeros_like(b_hh), b_hh


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


# ------------------------------ emit helpers ------------------------------


def _emit_conv(b: OnnxGraphBuilder, x: str, p: dict, strides=(1, 1),
               pads=(1, 1), transposed: bool = False) -> str:
    w = (flax_convtranspose_to_torch(p["kernel"]) if transposed
         else flax_conv_to_torch(p["kernel"]))
    ins = [x, b.add_init(w)]
    if "bias" in p:
        ins.append(b.add_init(_f32(p["bias"])))
    return b.add_node("ConvTranspose" if transposed else "Conv", ins,
                      strides=list(strides), pads=list(pads) * 2)


def _emit_norm(b: OnnxGraphBuilder, x: str, norm: str, params: dict,
               stats: dict | None, channels: int, group_size: int) -> str:
    if norm == "batch":
        ins = [x, b.add_init(_f32(params["scale"])),
               b.add_init(_f32(params["bias"])),
               b.add_init(_f32(stats["mean"])),
               b.add_init(_f32(stats["var"]))]
        return b.add_node("BatchNormalization", ins, epsilon=1e-5)
    ins = [x, b.add_init(_f32(params["scale"])),
           b.add_init(_f32(params["bias"]))]
    # flax GroupNorm's default epsilon is 1e-6 (BatchNorm's is 1e-5).
    return b.add_node("GroupNormalization", ins, epsilon=1e-6,
                      num_groups=channels // min(group_size, channels))


def _emit_gemm(b: OnnxGraphBuilder, x: str, p: dict, out: str | None = None) -> str:
    ins = [x, b.add_init(flax_linear_to_torch(p["kernel"])),
           b.add_init(_f32(p["bias"]))]
    return b.add_node("Gemm", ins, [out] if out else None,
                      alpha=1.0, beta=1.0, transB=1)


def _emit_linear3d(b: OnnxGraphBuilder, x: str, p: dict) -> str:
    """torch Linear on a rank-3 tensor: MatMul((..., in), (in, out)) + Add."""
    y = b.add_node("MatMul", [x, b.add_init(_f32(p["kernel"]))])
    return b.add_node("Add", [y, b.add_init(_f32(p["bias"]))])


# ------------------------------ binarizer ------------------------------


def _unet_conv_block(b, x, blk: dict, blk_stats: dict | None, norm: str,
                     feats: int) -> str:
    norm_cls = "BatchNorm" if norm == "batch" else "GroupNorm"
    for j in range(2):
        x = _emit_conv(b, x, blk[f"Conv_{j}"])
        x = _emit_norm(b, x, norm, blk[f"{norm_cls}_{j}"],
                       (blk_stats or {}).get(f"{norm_cls}_{j}"),
                       feats, group_size=16)
        x = b.add_node("Relu", [x])
    return x


def export_binarizer_graph(config, variables, path: str | Path) -> None:
    """AttentionUNet flax variables -> executable ``binarizer.onnx``
    (NCHW: input (B,3,H,W) float in [0,1] -> (B,1,H,W) probabilities,
    the interface inferred in SURVEY.md §2.2 from evaluate_binarize.py)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    feats = tuple(config.features)
    n = len(feats)
    b = OnnxGraphBuilder("binarizer")
    b.add_input("input", ("B", config.channels, config.height, config.width))

    x = "input"
    skips = []
    for i, f in enumerate(feats):
        x = _unet_conv_block(b, x, params[f"ConvBlock_{i}"],
                             stats.get(f"ConvBlock_{i}"), config.norm, f)
        skips.append(x)
        x = b.add_node("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _unet_conv_block(b, x, params[f"ConvBlock_{n}"],
                         stats.get(f"ConvBlock_{n}"), config.norm,
                         config.bottleneck)
    for j, (f, skip) in enumerate(zip(reversed(feats), reversed(skips))):
        x = _emit_conv(b, x, params[f"ConvTranspose_{j}"], strides=(2, 2),
                       pads=(0, 0), transposed=True)
        gate = params[f"AttentionGate_{j}"]
        a = _emit_conv(b, x, gate["gate_proj"], pads=(0, 0))
        s = _emit_conv(b, skip, gate["skip_proj"], pads=(0, 0))
        psi = _emit_conv(b, b.add_node("Relu", [b.add_node("Add", [a, s])]),
                         gate["psi"], pads=(0, 0))
        gated = b.add_node("Mul", [skip, b.add_node("Sigmoid", [psi])])
        x = b.add_node("Concat", [gated, x], axis=1)
        x = _unet_conv_block(b, x, params[f"ConvBlock_{n + 1 + j}"],
                             stats.get(f"ConvBlock_{n + 1 + j}"),
                             config.norm, f)
    logits = _emit_conv(b, x, params["head"], pads=(0, 0))
    b.add_node("Sigmoid", [logits], ["output"])
    b.add_output("output", ("B", 1, config.height, config.width))
    b.save(path, opset=21 if config.norm == "group" else 17)


# ------------------------------ encoder ------------------------------


def export_encoder_graph(config, variables, path: str | Path) -> None:
    """ResNetEncoder flax variables -> executable ``encoder.onnx``
    (NCHW: (B,3,224,224) -> (B,C,7,7) feature map)."""
    from stroke_derenderer_tpu_torch.models.encoder import ARCHS

    if config.encoder_arch not in ARCHS:
        raise ValueError(f"ONNX export writes ResNet encoders only; "
                         f"encoder_arch {config.encoder_arch!r} is not one")
    kind, stages, stem, _ = ARCHS[config.encoder_arch]
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    norm = config.encoder_norm
    norm_cls = "BatchNorm" if norm == "batch" else "GroupNorm"
    block_name = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    b = OnnxGraphBuilder("encoder")
    b.add_input("input", ("B", 3, config.image_size, config.image_size))

    def nrm(x, tree, tree_stats, j, channels):
        return _emit_norm(b, x, norm, tree[f"{norm_cls}_{j}"],
                          (tree_stats or {}).get(f"{norm_cls}_{j}"),
                          channels, group_size=8)

    x = _emit_conv(b, "input", params["stem"], strides=(2, 2), pads=(3, 3))
    x = b.add_node("Relu", [nrm(x, params, stats, 0, stem)])
    x = b.add_node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 1, 1, 1])
    idx = 0
    for i, n_blocks in enumerate(stages):
        feats = stem * (2 ** i)
        for blk_i in range(n_blocks):
            blk = params[f"{block_name}_{idx}"]
            blk_stats = stats.get(f"{block_name}_{idx}")
            idx += 1
            strides = 2 if (blk_i == 0 and i > 0) else 1
            residual = x
            if kind == "basic":
                y = _emit_conv(b, x, blk["Conv_0"], strides=(strides,) * 2)
                y = b.add_node("Relu", [nrm(y, blk, blk_stats, 0, feats)])
                y = _emit_conv(b, y, blk["Conv_1"])
                y = nrm(y, blk, blk_stats, 1, feats)
                out_ch, n_convs = feats, 2
            else:
                y = _emit_conv(b, x, blk["Conv_0"], pads=(0, 0))
                y = b.add_node("Relu", [nrm(y, blk, blk_stats, 0, feats)])
                y = _emit_conv(b, y, blk["Conv_1"], strides=(strides,) * 2)
                y = b.add_node("Relu", [nrm(y, blk, blk_stats, 1, feats)])
                y = _emit_conv(b, y, blk["Conv_2"], pads=(0, 0))
                y = nrm(y, blk, blk_stats, 2, feats * 4)
                out_ch, n_convs = feats * 4, 3
            if "proj" in blk:
                residual = _emit_conv(b, x, blk["proj"],
                                      strides=(strides,) * 2, pads=(0, 0))
                residual = nrm(residual, blk, blk_stats, n_convs, out_ch)
            x = b.add_node("Relu", [b.add_node("Add", [y, residual])])
    b.nodes[-1].outputs[0] = "output"
    c_out = stem * (2 ** (len(stages) - 1)) * (1 if kind == "basic" else 4)
    fm = config.image_size // 32
    b.add_output("output", ("B", c_out, fm, fm))
    b.save(path, opset=21 if norm == "group" else 17)


# ------------------------------ decoder ------------------------------


def export_decoder_graphs(config, variables, out_dir: str | Path,
                          proj_variables=None) -> None:
    """AttentiveDecoder flax variables -> the reference's four decode-side
    graphs (+ optional projection.onnx)."""
    p = variables["params"]
    out = Path(out_dir)
    emb_dim = int(np.asarray(p["embedding"]["embedding"]).shape[1])
    vocab = int(np.asarray(p["embedding"]["embedding"]).shape[0])
    enc_dim = int(np.asarray(p["enc_att"]["kernel"]).shape[0])
    att_dim = int(np.asarray(p["enc_att"]["kernel"]).shape[1])
    dec_dim = int(np.asarray(p["init_h"]["kernel"]).shape[1])
    n_pos = config.encode_image_size ** 2

    # decoder_embedding.onnx: tokens (B,) int -> embeddings (B, D).
    b = OnnxGraphBuilder("decoder_embedding")
    b.add_input("input", ("B",), elem_type=7)  # int64 indices
    table = b.add_init(_f32(p["embedding"]["embedding"]))
    b.add_node("Gather", [table, "input"], ["output"], axis=0)
    b.add_output("output", ("B", emb_dim))
    b.save(out / "decoder_embedding.onnx")

    # decoder_init_hc.onnx: mean-pooled encoding (B, E) -> h, c.
    b = OnnxGraphBuilder("decoder_init_hc")
    b.add_input("input", ("B", enc_dim))
    _emit_gemm(b, "input", p["init_h"], out="output_h")
    _emit_gemm(b, "input", p["init_c"], out="output_c")
    b.add_output("output_h", ("B", dec_dim))
    b.add_output("output_c", ("B", dec_dim))
    b.save(out / "decoder_init_hc.onnx")

    # decoder_iter.onnx: one attention + LSTM + vocab-head step.
    b = OnnxGraphBuilder("decoder_iter")
    b.add_input("input_enc", ("B", n_pos, enc_dim))
    b.add_input("input_emb", ("B", emb_dim))
    b.add_input("input_h", ("B", dec_dim))
    b.add_input("input_c", ("B", dec_dim))
    enc_proj = _emit_linear3d(b, "input_enc", p["enc_att"])   # (B, P, A)
    dec_proj = _emit_gemm(b, "input_h", p["dec_att"])         # (B, A)
    ax1 = b.add_init(np.asarray([1], np.int64), name="axes_1")
    ax0 = b.add_init(np.asarray([0], np.int64), name="axes_0")
    dec_proj = b.add_node("Unsqueeze", [dec_proj, ax1])       # (B, 1, A)
    att = _emit_linear3d(
        b, b.add_node("Relu", [b.add_node("Add", [enc_proj, dec_proj])]),
        p["full_att"])                                        # (B, P, 1)
    alpha = b.add_node("Softmax", [att], axis=1)
    awe = b.add_node("ReduceSum",
                     [b.add_node("Mul", [alpha, "input_enc"]), ax1],
                     keepdims=0)                              # (B, E)
    gate = b.add_node("Sigmoid", [_emit_gemm(b, "input_h", p["f_beta"])])
    awe = b.add_node("Mul", [gate, awe])
    x_cat = b.add_node("Concat", ["input_emb", awe], axis=1)  # (B, D+E)

    # Single LSTM op, ONNX iofc gate order (torch exports LSTMCell this way
    # via aten::lstm; graph_import parses both this and the two-Gemm form).
    w_ih, w_hh, b_ih, b_hh = flax_lstm_to_torch(p["lstm"])
    H = dec_dim

    def ifgo_to_iofc(m):
        i, f, g, o = (m[k * H:(k + 1) * H] for k in range(4))
        return np.concatenate([i, o, f, g], axis=0)

    W = b.add_init(ifgo_to_iofc(w_ih)[None])
    R = b.add_init(ifgo_to_iofc(w_hh)[None])
    B = b.add_init(np.concatenate([ifgo_to_iofc(b_ih),
                                   ifgo_to_iofc(b_hh)], 0)[None])
    xs = b.add_node("Unsqueeze", [x_cat, ax0])                # (1, B, D+E)
    h0 = b.add_node("Unsqueeze", ["input_h", ax0])
    c0 = b.add_node("Unsqueeze", ["input_c", ax0])
    b.add_node("LSTM", [xs, W, R, B, "", h0, c0],
               outputs=["lstm_y", "lstm_hN", "lstm_cN"], hidden_size=H)
    h2 = b.add_node("Squeeze", ["lstm_hN", ax0], ["output_h"])
    b.add_node("Squeeze", ["lstm_cN", ax0], ["output_c"])
    _emit_gemm(b, h2, p["fc"], out="output_pred")
    b.add_output("output_pred", ("B", vocab))
    b.add_output("output_h", ("B", dec_dim))
    b.add_output("output_c", ("B", dec_dim))
    b.save(out / "decoder_iter.onnx")

    if proj_variables is not None:
        # Projection maps the RAW encoder features to the decoder's
        # encoder_dim (evaluate_strokes.py:260-262), so its input width is
        # its own kernel's in-dim, not the decoder-side enc_dim.
        b = OnnxGraphBuilder("projection")
        pp = proj_variables["params"]
        in_dim = int(np.asarray(pp["kernel"]).shape[0])
        proj_dim = int(np.asarray(pp["kernel"]).shape[1])
        b.add_input("input", ("B", n_pos, in_dim))
        y = _emit_linear3d(b, "input", pp)
        b.nodes[-1].outputs[0] = "output"
        b.add_output("output", ("B", n_pos, proj_dim))
        b.save(out / "projection.onnx")


# --------------------------- turnkey exporter ---------------------------


def export_reference_models(models_dir: str | Path,
                            out_dir: str | Path) -> Path:
    """Native model dir (msgpack weights + config JSONs) -> an
    upstream-layout ONNX model dir. Returns ``out_dir``."""
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.weights import read_msgpack

    models = Path(models_dir)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    bin_cfg = BinarizerConfig.from_json(models / "configs_binarizer.json")
    bin_vars = read_msgpack(models / "binarizer.msgpack")
    export_binarizer_graph(bin_cfg, bin_vars, out / "binarizer.onnx")

    se_cfg = StrokesConfig.from_json(models / "configs_strokes.json")
    enc_vars = read_msgpack(models / "strokes_encoder.msgpack")
    dec_vars = read_msgpack(models / "strokes_decoder.msgpack")
    proj_vars = None
    if se_cfg.projection_dim:
        proj_path = models / "strokes_projection.msgpack"
        if not proj_path.exists():
            raise FileNotFoundError(
                f"configs_strokes.json declares projection_dim="
                f"{se_cfg.projection_dim} but {proj_path} is missing — "
                f"refusing to export a self-inconsistent artifact dir")
        proj_vars = read_msgpack(proj_path)
    export_encoder_graph(se_cfg, enc_vars, out / "encoder.onnx")
    export_decoder_graphs(se_cfg, dec_vars, out, proj_variables=proj_vars)

    (out / "configs_binarizer.json").write_text(
        json.dumps(bin_cfg.export_dict(), indent=1))
    (out / "configs_strokes.json").write_text(
        json.dumps(se_cfg.export_dict(), indent=1))
    return out

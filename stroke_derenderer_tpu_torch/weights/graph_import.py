"""ONNX graph -> flax-layout param trees for the upstream project's five
models.

A copy of the JAX package's ``weights/graph_import.py``, line for line in
its structural walk; its trees are numpy trees in flax's layout, which the
port's ``from_flax_*`` (:mod:`stroke_derenderer_tpu_torch.weights`) turn
into state dicts, so they can be compared leaf for leaf with the JAX
package's.

The upstream project ships its models as five ONNX graphs (its
``main.py:43-62``): ``binarizer.onnx``, ``encoder.onnx``, optional
``projection.onnx``, ``decoder_init_hc.onnx``, ``decoder_embedding.onnx``,
``decoder_iter.onnx``. Their tensor NAMES are whatever torch.onnx.export
emitted (often ``onnx::Conv_123``), so mapping by name is hopeless; this
module maps by GRAPH STRUCTURE instead:

  1. parse nodes in execution order (:mod:`.onnx_graph`),
  2. reduce them to the sequence of parameterized ops (conv / conv-transpose
     / batch-norm / linear / embedding / LSTM), folding torch's
     MatMul+Add linear split and both LSTM export styles (single ONNX
     ``LSTM`` op in iofc gate order, or decomposed packed 4H Gemms in
     torch ifgo order),
  3. walk the module tree in forward-execution order (the architectures
     are first-party: models/unet.py, models/encoder.py, models/decoder.py)
     and consume ops one-to-one, converting torch layouts (:mod:`.importer`)
     and validating every shape,
  4. where the export carries a BatchNorm this architecture has no slot
     for (e.g. BN inside attention gates, as in public attention-UNet
     implementations), FOLD it into the preceding conv — exact in
     inference mode: w' = w*s/sqrt(v+eps), b' = (b-m)*s/sqrt(v+eps)+beta.

Architecture hyperparameters (features, widths, depths) are INFERRED from
the tensors themselves, so ``import_reference_models(dir)`` needs only the
ONNX files plus the upstream project's two pipeline-constant JSONs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.weights.importer import (
    torch_conv_to_flax, torch_linear_to_flax, torch_lstm_to_flax,
)
from stroke_derenderer_tpu_torch.weights.onnx_graph import OnnxGraph, read_onnx_graph


def torch_convtranspose_to_flax(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (cin, cout, kh, kw) -> flax ConvTranspose
    (kh, kw, cin, cout), with the spatial flip that reconciles torch's
    gradient-of-conv semantics with lax.conv_transpose's
    transpose_kernel=False convention."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


class GraphImportError(ValueError):
    pass


# --------------------- step 2: parameterized op list ---------------------


class ParamOp:
    def __init__(self, kind: str, node, **tensors):
        self.kind = kind          # conv | convT | bn | linear | embed | lstm
        self.node = node
        self.tensors = tensors    # torch-layout arrays

    def __repr__(self):
        shapes = {k: getattr(v, "shape", v) for k, v in self.tensors.items()}
        return f"ParamOp({self.kind}, {shapes})"


def extract_param_ops(graph: OnnxGraph) -> list[ParamOp]:
    """The graph's parameterized ops in execution order."""
    inits = graph.initializers
    ops: list[ParamOp] = []
    # output tensor name -> index into ops, for MatMul+Add bias folding
    produced: dict[str, int] = {}

    for node in graph.nodes:
        t = node.op_type
        if t in ("Conv", "ConvTranspose"):
            w = inits[node.inputs[1]]
            b = inits[node.inputs[2]] if len(node.inputs) > 2 else None
            ops.append(ParamOp("conv" if t == "Conv" else "convT", node,
                               weight=w, bias=b))
            produced[node.outputs[0]] = len(ops) - 1
        elif t == "BatchNormalization":
            s, beta, mean, var = (inits[n] for n in node.inputs[1:5])
            ops.append(ParamOp("bn", node, scale=s, bias=beta, mean=mean,
                               var=var,
                               eps=float(node.attrs.get("epsilon", 1e-5))))
            produced[node.outputs[0]] = len(ops) - 1
        elif t == "GroupNormalization":
            # Per-channel scale/bias (opset-21 semantics; graph_export.py
            # emits these for norm="group" models).
            s, beta = inits[node.inputs[1]], inits[node.inputs[2]]
            ops.append(ParamOp("gn", node, scale=s, bias=beta,
                               eps=float(node.attrs.get("epsilon", 1e-5))))
            produced[node.outputs[0]] = len(ops) - 1
        elif t == "Gemm":
            w = inits[node.inputs[1]]
            if not int(node.attrs.get("transB", 0)):
                w = np.transpose(w)  # canonical torch layout (out, in)
            b = inits[node.inputs[2]] if len(node.inputs) > 2 else None
            ops.append(ParamOp("linear", node, weight=w, bias=b))
            produced[node.outputs[0]] = len(ops) - 1
        elif t == "MatMul" and node.inputs[1] in inits:
            # torch Linear on a 3D tensor: MatMul((..., in), (in, out)).
            w = np.transpose(inits[node.inputs[1]])  # -> (out, in)
            ops.append(ParamOp("linear", node, weight=w, bias=None))
            produced[node.outputs[0]] = len(ops) - 1
        elif t == "Add":
            # Bias of a split torch Linear: Add(matmul_out, bias_init).
            names = node.inputs
            init_in = [n for n in names if n in inits]
            data_in = [n for n in names if n in produced]
            if len(init_in) == 1 and len(data_in) == 1:
                op = ops[produced[data_in[0]]]
                if op.kind == "linear" and op.tensors["bias"] is None:
                    op.tensors["bias"] = inits[init_in[0]].reshape(-1)
                    produced[node.outputs[0]] = produced[data_in[0]]
        elif t == "Gather" and node.inputs[0] in inits:
            table = inits[node.inputs[0]]
            if table.ndim == 2:  # embedding lookup
                ops.append(ParamOp("embed", node, weight=table))
        elif t == "LSTM":
            # ONNX LSTM gate order is iofc; torch packs ifgo.
            W = inits[node.inputs[1]][0]   # (4H, in)
            R = inits[node.inputs[2]][0]   # (4H, H)
            B = (inits[node.inputs[3]][0] if len(node.inputs) > 3
                 and node.inputs[3] in inits else
                 np.zeros(2 * W.shape[0], W.dtype))
            H = R.shape[1]

            def iofc_to_ifgo(m):
                i, o, f, c = (m[k * H:(k + 1) * H] for k in range(4))
                return np.concatenate([i, f, c, o], axis=0)

            ops.append(ParamOp("lstm", node,
                               w_ih=iofc_to_ifgo(W), w_hh=iofc_to_ifgo(R),
                               b_ih=iofc_to_ifgo(B[:4 * H]),
                               b_hh=iofc_to_ifgo(B[4 * H:])))
        # every other op type carries no trainable parameters we map
    return ops


def _merge_lstm_halves(ops: list[ParamOp], hidden: int) -> list[ParamOp]:
    """Fuse a decomposed LSTMCell export — two packed (4H, *) linears in
    torch ifgo order — into one 'lstm' ParamOp."""
    out: list[ParamOp] = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if (op.kind == "linear" and op.tensors["weight"].shape[0] == 4 * hidden
                and i + 1 < len(ops) and ops[i + 1].kind == "linear"
                and ops[i + 1].tensors["weight"].shape == (4 * hidden, hidden)):
            ih, hh = op.tensors, ops[i + 1].tensors
            zeros = np.zeros(4 * hidden, ih["weight"].dtype)
            out.append(ParamOp(
                "lstm", op.node, w_ih=ih["weight"], w_hh=hh["weight"],
                b_ih=ih["bias"] if ih["bias"] is not None else zeros,
                b_hh=hh["bias"] if hh["bias"] is not None else zeros))
            i += 2
        else:
            out.append(op)
            i += 1
    return out


# --------------------- step 3: slot walk + conversion ---------------------


def _set(tree: dict, path: tuple[str, ...], leaf: str, value) -> None:
    d = tree
    for k in path:
        d = d.setdefault(k, {})
    d[leaf] = value


class _Walker:
    """Consume ParamOps against the flax module slots in forward order."""

    def __init__(self, ops: list[ParamOp], what: str):
        self.ops = ops
        self.pos = 0
        self.what = what
        self.params: dict = {}
        self.stats: dict = {}

    def _next(self, kinds: tuple[str, ...]) -> ParamOp:
        if self.pos >= len(self.ops):
            raise GraphImportError(
                f"{self.what}: ran out of ONNX ops while expecting {kinds} "
                f"(consumed {self.pos})")
        op = self.ops[self.pos]
        if op.kind not in kinds:
            raise GraphImportError(
                f"{self.what}: op {self.pos} is {op.kind}, expected {kinds} "
                f"({op!r})")
        self.pos += 1
        return op

    def _peek_is(self, kind: str) -> bool:
        return self.pos < len(self.ops) and self.ops[self.pos].kind == kind

    def conv(self, path: tuple[str, ...], cout: int, has_bias: bool,
             transposed: bool = False):
        op = self._next(("convT",) if transposed else ("conv",))
        w = op.tensors["weight"]
        b = op.tensors["bias"]
        onnx_cout = w.shape[1] if transposed else w.shape[0]
        if onnx_cout != cout:
            raise GraphImportError(
                f"{self.what}: {'/'.join(path)} expects {cout} out-channels, "
                f"ONNX conv has {onnx_cout} (weight {w.shape})")
        if has_bias:
            # No norm slot follows in this architecture; if the export has
            # a BatchNorm consuming THIS conv's output (e.g. BN inside
            # attention gates, as public attention-UNets do), fold it into
            # the conv — exact in inference mode. Matched by topology, not
            # adjacency: torch traces sibling convs before their norms.
            out_name = op.node.outputs[0]
            for j in range(self.pos, len(self.ops)):
                cand = self.ops[j]
                if cand.kind == "bn" and cand.node.inputs[0] == out_name:
                    bn = self.ops.pop(j)
                    g = bn.tensors["scale"] / np.sqrt(bn.tensors["var"]
                                                      + bn.tensors["eps"])
                    w = w * g.reshape((1, -1, 1, 1) if transposed
                                      else (-1, 1, 1, 1))
                    b0 = b if b is not None else 0.0
                    b = (b0 - bn.tensors["mean"]) * g + bn.tensors["bias"]
                    break
        kernel = (torch_convtranspose_to_flax(w) if transposed
                  else torch_conv_to_flax(w))
        _set(self.params, path, "kernel", kernel)
        if has_bias:
            _set(self.params, path, "bias",
                 b if b is not None else np.zeros(cout, w.dtype))
        elif b is not None:
            raise GraphImportError(
                f"{self.what}: {'/'.join(path)} is bias-free in this "
                f"architecture but the ONNX conv carries a bias")

    def bn(self, path: tuple[str, ...]):
        op = self._next(("bn",))
        _set(self.params, path, "scale", op.tensors["scale"])
        _set(self.params, path, "bias", op.tensors["bias"])
        _set(self.stats, path, "mean", op.tensors["mean"])
        _set(self.stats, path, "var", op.tensors["var"])

    def norm(self, path_prefix: tuple[str, ...], idx: int) -> str:
        """Consume either norm kind into its flax auto-name slot
        (GroupNorm_{idx} params-only, or BatchNorm_{idx} + batch_stats).
        Returns the norm kind consumed ("group" | "batch")."""
        if self._peek_is("gn"):
            op = self._next(("gn",))
            path = path_prefix + (f"GroupNorm_{idx}",)
            _set(self.params, path, "scale", op.tensors["scale"])
            _set(self.params, path, "bias", op.tensors["bias"])
            return "group"
        self.bn(path_prefix + (f"BatchNorm_{idx}",))
        return "batch"

    def linear(self, path: tuple[str, ...], shape_out_in: tuple[int, int]):
        op = self._next(("linear",))
        w = op.tensors["weight"]
        if tuple(w.shape) != tuple(shape_out_in):
            raise GraphImportError(
                f"{self.what}: {'/'.join(path)} expects weight "
                f"{shape_out_in} (out,in), ONNX has {w.shape}")
        _set(self.params, path, "kernel", torch_linear_to_flax(w))
        b = op.tensors["bias"]
        _set(self.params, path, "bias",
             b if b is not None else np.zeros(w.shape[0], w.dtype))

    def embed(self, path: tuple[str, ...]):
        op = self._next(("embed",))
        _set(self.params, path, "embedding", op.tensors["weight"])

    def lstm(self, path: tuple[str, ...], hidden: int):
        op = self._next(("lstm",))
        t = op.tensors
        if t["w_hh"].shape != (4 * hidden, hidden):
            raise GraphImportError(
                f"{self.what}: LSTM hidden mismatch — expected w_hh "
                f"{(4 * hidden, hidden)}, got {t['w_hh'].shape}")
        cell = torch_lstm_to_flax(t["w_ih"], t["w_hh"], t["b_ih"], t["b_hh"])
        for gate, tree in cell.items():
            for leaf, val in tree.items():
                _set(self.params, path + (gate,), leaf, val)

    def finish(self):
        if self.pos != len(self.ops):
            raise GraphImportError(
                f"{self.what}: {len(self.ops) - self.pos} ONNX ops left over "
                f"after the architecture walk "
                f"(next: {self.ops[self.pos]!r})")
        out = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        return out


# ------------------------------ binarizer ------------------------------


def infer_unet_dims(ops: list[ParamOp]) -> tuple[tuple[int, ...], int]:
    """(features, bottleneck) from the conv shapes: down/bottleneck blocks
    are conv-bn pairs; the first ConvTranspose marks the turn."""
    outs = []
    i = 0
    while i < len(ops) and ops[i].kind != "convT":
        if ops[i].kind == "conv":
            outs.append(ops[i].tensors["weight"].shape[0])
        i += 1
    if len(outs) < 4 or len(outs) % 2:
        raise GraphImportError(
            f"unet: cannot infer encoder widths from conv sequence {outs}")
    widths = outs[::2]  # two same-width convs per block
    return tuple(widths[:-1]), widths[-1]


def map_binarizer_graph(path: str | Path, config=None):
    """binarizer.onnx -> (BinarizerConfig, flax variables)."""
    from stroke_derenderer_tpu_torch.config import BinarizerConfig

    graph = read_onnx_graph(path)
    ops = extract_param_ops(graph)
    features, bottleneck = infer_unet_dims(ops)
    # Torch exports carry BatchNorm; this framework's own ONNX exports
    # (weights/graph_export.py) carry GroupNormalization for norm="group".
    norm = "group" if any(o.kind == "gn" for o in ops) else "batch"
    if config is None or (tuple(config.features) != features
                          or config.bottleneck != bottleneck
                          or config.norm != norm):
        base = config or BinarizerConfig()
        import dataclasses
        config = dataclasses.replace(base, features=features,
                                     bottleneck=bottleneck, norm=norm)
    w = _Walker(ops, "binarizer")
    n = len(features)

    def conv_block(idx: int, feats: int):
        blk = (f"ConvBlock_{idx}",)
        for j in range(2):
            w.conv(blk + (f"Conv_{j}",), feats, has_bias=False)
            w.norm(blk, j)

    for i, f in enumerate(features):
        conv_block(i, f)
    conv_block(n, bottleneck)
    for j, f in enumerate(reversed(features)):
        w.conv((f"ConvTranspose_{j}",), f, has_bias=True, transposed=True)
        gate = (f"AttentionGate_{j}",)
        inter = max(f // 2, 4)
        w.conv(gate + ("gate_proj",), inter, has_bias=True)
        w.conv(gate + ("skip_proj",), inter, has_bias=True)
        w.conv(gate + ("psi",), 1, has_bias=True)
        conv_block(n + 1 + j, f)
    w.conv(("head",), 1, has_bias=True)
    return config, w.finish()


# ------------------------------ encoder ------------------------------


def infer_resnet_arch(ops: list[ParamOp]) -> str:
    """Match the conv/bn sequence against the known ARCHS table."""
    from stroke_derenderer_tpu_torch.models.encoder import ARCHS

    n_conv = sum(1 for o in ops if o.kind == "conv")
    stem_width = next(o.tensors["weight"].shape[0] for o in ops
                      if o.kind == "conv")
    for arch, (kind, stages, stem, _) in ARCHS.items():
        per_block = 2 if kind == "basic" else 3
        expected = 1  # stem
        for i, nb in enumerate(stages):
            for b in range(nb):
                expected += per_block
                first = (b == 0)
                if first and (i > 0 or kind == "bottleneck"):
                    expected += 1  # projection shortcut
        if expected == n_conv and stem == stem_width:
            return arch
    raise GraphImportError(
        f"encoder: no known resnet arch has {n_conv} convs / stem "
        f"{stem_width}")


def map_encoder_graph(path: str | Path, config=None):
    """encoder.onnx -> (arch name, norm kind, flax variables)."""
    from stroke_derenderer_tpu_torch.models.encoder import ARCHS

    graph = read_onnx_graph(path)
    ops = extract_param_ops(graph)
    arch = infer_resnet_arch(ops)
    norm = "group" if any(o.kind == "gn" for o in ops) else "batch"
    kind, stages, stem, _ = ARCHS[arch]
    w = _Walker(ops, "encoder")
    w.conv(("stem",), stem, has_bias=False)
    w.norm((), 0)
    block_name = "BasicBlock" if kind == "basic" else "BottleneckBlock"
    idx = 0
    for i, n_blocks in enumerate(stages):
        feats = stem * (2 ** i)
        for b in range(n_blocks):
            blk = (f"{block_name}_{idx}",)
            idx += 1
            n_convs = 2 if kind == "basic" else 3
            outs = ([feats, feats] if kind == "basic"
                    else [feats, feats, feats * 4])
            for j in range(n_convs):
                w.conv(blk + (f"Conv_{j}",), outs[j], has_bias=False)
                w.norm(blk, j)
            has_proj = (b == 0) and (i > 0 or kind == "bottleneck")
            if has_proj:
                w.conv(blk + ("proj",), outs[-1], has_bias=False)
                w.norm(blk, n_convs)
    return arch, norm, w.finish()


# ------------------------------ decoder ------------------------------


def map_decoder_graphs(init_path: str | Path, emb_path: str | Path,
                       iter_path: str | Path, proj_path=None):
    """The three (or four) decoder graphs -> (dims dict, flax variables
    [, projection variables])."""
    emb_ops = extract_param_ops(read_onnx_graph(emb_path))
    if len(emb_ops) != 1 or emb_ops[0].kind != "embed":
        raise GraphImportError(
            f"decoder_embedding: expected one embedding Gather, got "
            f"{emb_ops}")
    vocab, embed_dim = emb_ops[0].tensors["weight"].shape

    init_ops = extract_param_ops(read_onnx_graph(init_path))
    if len(init_ops) != 2 or any(o.kind != "linear" for o in init_ops):
        raise GraphImportError(
            f"decoder_init_hc: expected two linears (init_h, init_c), got "
            f"{init_ops}")
    # Reference export names its outputs output_h / output_c
    # (evaluate_strokes.py:265-266); honor them if present, else take
    # graph order as (h, c).
    h_first = True
    outs = [o.node.outputs[0] for o in init_ops]
    if any("output_c" in o for o in outs):
        h_first = not ("output_c" in outs[0])
    op_h, op_c = (init_ops if h_first else init_ops[::-1])
    decoder_dim, encoder_dim = op_h.tensors["weight"].shape

    iter_ops = _merge_lstm_halves(
        extract_param_ops(read_onnx_graph(iter_path)), decoder_dim)
    # show-attend-tell iter order: enc_att, dec_att, full_att, f_beta,
    # LSTM cell, vocab fc (evaluate_strokes.py:280-288 calls one graph that
    # contains all of these).
    non_lstm = [o for o in iter_ops if o.kind == "linear"]
    lstms = [o for o in iter_ops if o.kind == "lstm"]
    if len(lstms) != 1 or len(non_lstm) != 5:
        raise GraphImportError(
            f"decoder_iter: expected 5 linears + 1 LSTM cell, got "
            f"{[o.kind for o in iter_ops]}")
    attention_dim = non_lstm[0].tensors["weight"].shape[0]

    w = _Walker([], "decoder")
    w.ops = [emb_ops[0], non_lstm[0], non_lstm[1], non_lstm[2], op_h, op_c,
             non_lstm[3], lstms[0], non_lstm[4]]
    w.embed(("embedding",))
    w.linear(("enc_att",), (attention_dim, encoder_dim))
    w.linear(("dec_att",), (attention_dim, decoder_dim))
    w.linear(("full_att",), (1, attention_dim))
    w.linear(("init_h",), (decoder_dim, encoder_dim))
    w.linear(("init_c",), (decoder_dim, encoder_dim))
    w.linear(("f_beta",), (encoder_dim, decoder_dim))
    w.lstm(("lstm",), decoder_dim)
    w.linear(("fc",), (vocab, decoder_dim))
    variables = w.finish()

    dims = {"vocab_size": int(vocab), "embed_dim": int(embed_dim),
            "attention_dim": int(attention_dim),
            "decoder_dim": int(decoder_dim), "encoder_dim": int(encoder_dim)}

    proj_vars = None
    if proj_path is not None:
        pops = extract_param_ops(read_onnx_graph(proj_path))
        if len(pops) != 1 or pops[0].kind != "linear":
            raise GraphImportError(
                f"projection: expected one linear, got {pops}")
        pw = _Walker(pops, "projection")
        out_dim, in_dim = pops[0].tensors["weight"].shape
        pw.linear((), (out_dim, in_dim))
        proj_vars = pw.finish()
        dims["projection_dim"] = int(out_dim)
    return dims, variables, proj_vars


# --------------------------- turnkey importer ---------------------------


def import_reference_models(onnx_dir: str | Path,
                            out_dir: str | Path | None = None):
    """Load the upstream project's model directory (the five ONNX graphs +
    two config JSONs, its main.py:43-62) into flax-layout variables (numpy
    trees), optionally writing a native model dir the CLI loads directly.

    Returns (bin_config, bin_vars, strokes_config, enc_vars, dec_vars,
    proj_vars)."""
    import dataclasses

    from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig

    onnx_dir = Path(onnx_dir)
    bin_cfg = BinarizerConfig.from_json(
        onnx_dir / "configs_binarizer.json"
        if (onnx_dir / "configs_binarizer.json").exists() else None)
    bin_cfg, bin_vars = map_binarizer_graph(onnx_dir / "binarizer.onnx",
                                            bin_cfg)

    arch, enc_norm, enc_vars = map_encoder_graph(onnx_dir / "encoder.onnx")
    proj_path = (onnx_dir / "projection.onnx"
                 if (onnx_dir / "projection.onnx").exists() else None)
    dims, dec_vars, proj_vars = map_decoder_graphs(
        onnx_dir / "decoder_init_hc.onnx",
        onnx_dir / "decoder_embedding.onnx",
        onnx_dir / "decoder_iter.onnx", proj_path)

    se_cfg = StrokesConfig.from_json(
        onnx_dir / "configs_strokes.json"
        if (onnx_dir / "configs_strokes.json").exists() else None)
    se_cfg = dataclasses.replace(
        se_cfg, encoder_arch=arch, encoder_norm=enc_norm,
        embed_dim=dims["embed_dim"], attention_dim=dims["attention_dim"],
        decoder_dim=dims["decoder_dim"],
        projection_dim=dims.get("projection_dim", 0))
    if se_cfg.vocab_size != dims["vocab_size"]:
        raise GraphImportError(
            f"decoder vocab {dims['vocab_size']} does not match "
            f"3 + 2*image_size = {se_cfg.vocab_size}")

    if out_dir is not None:
        from stroke_derenderer_tpu_torch.weights import save_model_files
        save_model_files(out_dir, bin_vars, bin_cfg, enc_vars, dec_vars,
                         se_cfg, proj_vars)
    return bin_cfg, bin_vars, se_cfg, enc_vars, dec_vars, proj_vars

"""Torch-backed ONNX graph executor.

A copy of the JAX package's ``weights/onnx_run.py``: executes the op set
:mod:`.graph_export` emits (and the upstream project's five graphs use)
with torch CPU ops, a stand-in for ONNX Runtime (:class:`TorchOnnxSession`
takes ``onnxruntime.InferenceSession``'s place). The tests run every
exported graph through it and hold its outputs to the port's forwards, a
check that does not share layout code with the exporter (no flax-layout
helpers, no :mod:`.graph_import`), so an exporter bug cannot validate
itself. Nothing on the inference path uses it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stroke_derenderer_tpu_torch.weights.onnx_graph import read_onnx_graph


def _axes(node, ins):
    """axes as attribute (opset <13 style) or as trailing input tensor."""
    if "axes" in node.attrs:
        return list(node.attrs["axes"])
    return [int(v) for v in ins[-1].reshape(-1).tolist()]


def _execute(g, env: dict) -> dict:
    """Run parsed graph ``g`` over a {name: torch.Tensor} environment."""
    for node in g.nodes:
        ins = [env[n] if n else None for n in node.inputs]
        a = node.attrs
        t = node.op_type
        if t in ("Conv", "ConvTranspose"):
            pads = list(a.get("pads", [0, 0, 0, 0]))
            strides = tuple(a.get("strides", [1, 1]))
            assert pads[:2] == pads[2:], f"asymmetric pads {pads}"
            # Unsupported attributes must fail loudly like unknown ops do —
            # silently computing a dense dilation-1 conv would corrupt the
            # independent-executor check this module exists for.
            dil = list(a.get("dilations", [1, 1]))
            assert dil == [1] * len(dil), f"dilations {dil} unsupported"
            assert int(a.get("group", 1)) == 1, \
                f"group={a.get('group')} unsupported"
            fn = F.conv2d if t == "Conv" else F.conv_transpose2d
            out = fn(ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                     stride=strides, padding=tuple(pads[:2]))
        elif t == "BatchNormalization":
            out = F.batch_norm(ins[0], ins[3], ins[4], ins[1], ins[2],
                               training=False, eps=a.get("epsilon", 1e-5))
        elif t == "GroupNormalization":
            out = F.group_norm(ins[0], int(a["num_groups"]), ins[1], ins[2],
                               eps=a.get("epsilon", 1e-5))
        elif t == "Relu":
            out = torch.relu(ins[0])
        elif t == "Sigmoid":
            out = torch.sigmoid(ins[0])
        elif t == "MaxPool":
            pads = list(a.get("pads", [0, 0, 0, 0]))
            out = F.max_pool2d(ins[0], tuple(a["kernel_shape"]),
                               stride=tuple(a["strides"]),
                               padding=tuple(pads[:2]))
        elif t == "Add":
            out = ins[0] + ins[1]
        elif t == "Mul":
            out = ins[0] * ins[1]
        elif t == "Concat":
            out = torch.cat([i for i in ins], dim=int(a["axis"]))
        elif t == "Gemm":
            assert not int(a.get("transA", 0)), "Gemm transA unsupported"
            w = ins[1].t() if int(a.get("transB", 0)) else ins[1]
            out = a.get("alpha", 1.0) * (ins[0] @ w)
            if len(ins) > 2:
                out = out + a.get("beta", 1.0) * ins[2]
        elif t == "MatMul":
            out = torch.matmul(ins[0], ins[1])
        elif t == "Softmax":
            out = torch.softmax(ins[0], dim=int(a.get("axis", -1)))
        elif t == "ReduceSum":
            dims = _axes(node, ins)
            out = ins[0].sum(dim=dims, keepdim=bool(a.get("keepdims", 1)))
        elif t == "Unsqueeze":
            out = ins[0]
            for ax in sorted(_axes(node, ins)):
                out = out.unsqueeze(ax)
        elif t == "Squeeze":
            out = ins[0]
            for ax in sorted(_axes(node, ins), reverse=True):
                out = out.squeeze(ax)
        elif t == "Gather":
            out = torch.index_select(ins[0], int(a.get("axis", 0)),
                                     ins[1].reshape(-1).long())
        elif t == "LSTM":
            X, W, R, B = ins[0], ins[1][0], ins[2][0], ins[3][0]
            h, c = ins[5][0], ins[6][0]
            H = int(a["hidden_size"])
            ys = []
            for step in range(X.shape[0]):
                gates = X[step] @ W.t() + h @ R.t() + B[:4 * H] + B[4 * H:]
                i, o, f, gg = (gates[:, k * H:(k + 1) * H] for k in range(4))
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
                h = torch.sigmoid(o) * torch.tanh(c)
                ys.append(h)
            env[node.outputs[0]] = torch.stack(ys)[:, None]
            env[node.outputs[1]] = h[None]
            env[node.outputs[2]] = c[None]
            continue
        else:
            raise NotImplementedError(f"op {t}")
        env[node.outputs[0]] = out
    return env


def run_onnx(path, feeds: dict) -> dict:
    """Execute an ONNX graph file; returns {output_name: np.ndarray}."""
    g = read_onnx_graph(path)
    env = {k: torch.from_numpy(np.array(v))
           for k, v in g.initializers.items()}
    for k, v in feeds.items():
        env[k] = torch.from_numpy(np.array(v))
    env = _execute(g, env)
    return {o: env[o].numpy() for o in g.outputs}


class TorchOnnxSession:
    """``onnxruntime.InferenceSession`` drop-in over :func:`run_onnx`'s
    executor: the graph is parsed once and its initializers converted to
    tensors once, at construction."""

    def __init__(self, path, providers=None, sess_options=None, **kw):
        self._graph = read_onnx_graph(path)
        self._inits = {k: torch.from_numpy(np.array(v))
                       for k, v in self._graph.initializers.items()}

    def run(self, output_names, feeds: dict) -> list:
        """The outputs ``output_names`` (all, in graph order, when None) as
        numpy arrays for the input ``feeds`` {name: array}."""
        env = dict(self._inits)
        for k, v in feeds.items():
            env[k] = torch.from_numpy(np.array(v))
        env = _execute(self._graph, env)
        return [env[n].numpy() for n in (output_names or self._graph.outputs)]

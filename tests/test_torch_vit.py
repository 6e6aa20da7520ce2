"""The ViT glyph encoder (``models/vit.py``) on the CPU, held to the plain
float32 reference ``tests/plain_vit.py`` on seeded random weights in the
flax layout that a model directory holds: the module alone in float32
and bf16, and the whole ``process_images`` path of a model directory
(decoder input tapped after the projection); ``vit_l16``'s leaf shapes,
width, positions and operations on the ``meta`` device; its span and
token counter under a profile; and the clear errors where a ViT cannot
go."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_vit
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import config as tconfig
from stroke_derenderer_tpu_torch.data.synthetic import rasterize_strokes
from stroke_derenderer_tpu_torch.models.encoder import (
    encoder_width, make_encoder,
)
from stroke_derenderer_tpu_torch.models.vit import ViTEncoder
from stroke_derenderer_tpu_torch.pipeline.strokes import StrokeEstimator
from stroke_derenderer_tpu_torch.utils import profiling as tp
from stroke_derenderer_tpu_torch.utils.flops import flops
from stroke_derenderer_tpu_torch.weights import (
    encoder_state, materialize_model_dir, vit_variables, write_msgpack,
)

TINY_BIN = tconfig.BinarizerConfig(features=(8, 16), bottleneck=16,
                                   compute_dtype="float32")
# vit_tiny: patch 16, hidden 64, 2 blocks, 4 heads, MLP 256; 64-px crops,
# so 4 x 4 patches.
TINY_VIT = tconfig.StrokesConfig(
    encoder_arch="vit_tiny", image_size=64, encode_image_size=4,
    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), embed_dim=16,
    attention_dim=16, decoder_dim=16, projection_dim=24, max_length=6,
    compute_dtype="float32")
TINY_RESNET = tconfig.StrokesConfig(encoder_arch="tiny", embed_dim=16,
                                    attention_dim=16, decoder_dim=16,
                                    max_length=6, compute_dtype="float32")
VIT_L16_FLOPS = 123_107_377_152


def layout(patch, hidden, depth, heads, mlp, tokens) -> dict:
    """The leaf shapes of a ViT's ``strokes_encoder.msgpack`` params."""
    def dense(i, o):
        return {"kernel": (i, o), "bias": (o,)}

    def norm():
        return {"scale": (hidden,), "bias": (hidden,)}

    block = {"LayerNorm_0": norm(), "query": dense(hidden, hidden),
             "key": dense(hidden, hidden), "value": dense(hidden, hidden),
             "out": {"kernel": (heads, hidden // heads, hidden),
                     "bias": (hidden,)},
             "LayerNorm_1": norm(), "Dense_0": dense(hidden, mlp),
             "Dense_1": dense(mlp, hidden)}
    return {"patch": {"kernel": (patch, patch, 3, hidden), "bias": (hidden,)},
            "cls": {"embedding": (1, hidden)},
            "pos": {"embedding": (tokens, hidden)},
            **{f"Block_{i}": block for i in range(depth)},
            "LayerNorm_final": norm()}


def draw(shapes: dict, gen: torch.Generator) -> dict:
    """Seeded float32 values for every leaf: kernels N(0, 1 / fan-in),
    embeddings N(0, 1 / width), norm scales 1 + N(0, 0.01), biases N(0,
    0.01), so that a leaf read in the wrong place shows."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = draw(v, gen)
            continue
        t = torch.randn(v, generator=gen)
        scale = {"kernel": float(np.prod(v[:-1])) ** -0.5,
                 "embedding": v[-1] ** -0.5}.get(k, 0.1)
        out[k] = (t * scale + (k == "scale")).numpy()
    return out


def tensors(tree: dict) -> dict:
    return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


TINY_TREE = draw(layout(16, 64, 2, 4, 256, 17),
                 torch.Generator().manual_seed(21))


def fp8(x):
    """x rounded to float8 e4m3 on one scale."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_matches_plain_reference(dtype):
    """Within 1e-5 of the largest output in float32. In bf16 within 2.5%:
    bf16 keeps 8 significant bits (2^-9 relative a rounding), and the ~10
    roundings of a block over 2 blocks, the LayerNorms' rescaling
    included, read 0.8-1.0% here; float8 activations (4 bits, 16x
    coarser) read 5.7-6.5%, and must fail the same bound."""
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    ref = plain_vit.forward(tensors(TINY_TREE), x)
    port = ViTEncoder("vit_tiny", 64, getattr(torch, dtype)).eval()
    port.load_state_dict(encoder_state({"params": TINY_TREE}, "vit_tiny"))
    with torch.no_grad():
        got = port(x)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (3, 16, 64)
    tol = 1e-5 if dtype == "float32" else 0.025
    top = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol * top
    if dtype == "bfloat16":
        low = plain_vit.forward(tensors(TINY_TREE), x, act=fp8)
        assert float((low - ref).abs().max()) > tol * top


@pytest.fixture(scope="module")
def vit_dir(tmp_path_factory):
    """A tiny model directory whose encoder is ``TINY_TREE``."""
    d = tmp_path_factory.mktemp("vit_models")
    materialize_model_dir(d, TINY_BIN, TINY_VIT)
    write_msgpack({"params": TINY_TREE}, d / "strokes_encoder.msgpack")
    return d


def _masks():
    """Two masks of a few pen strokes each."""
    rng = np.random.default_rng(3)
    out = []
    for w in (160, 230):
        strokes = []
        for x0 in range(10, w - 40, 60):
            xs = x0 + np.cumsum(rng.integers(2, 8, 5))
            ys = 20 + rng.integers(0, 20, 5)
            strokes.append((xs.astype(float), ys.astype(float)))
        out.append(rasterize_strokes(strokes, (64, w), thickness=3) > 0)
    return out


def _tap(est):
    """Wraps the estimator's gather and its decoder's ``project_encoding``
    to keep the crops and the decoder input of each call."""
    seen = {"crops": [], "seq": []}
    gather, project = est._gather_batch, est.decoder.project_encoding

    def gather_w(imgs):
        out = gather(imgs)
        seen["crops"].append(out[0])
        return out

    def project_w(seq):
        seen["seq"].append(seq)
        return project(seq)

    est._gather_batch, est.decoder.project_encoding = gather_w, project_w
    return seen


def plain_normalize(crops, mean, std):
    """(N, S, S) crops in 0..255 -> min-max stretched, then mean/std."""
    mn = crops.amin(dim=(1, 2), keepdim=True)
    mx = crops.amax(dim=(1, 2), keepdim=True)
    x = torch.where(mx > mn, (crops - mn) * 255.0 / (mx - mn).clamp_min(1e-12),
                    torch.zeros_like(crops))
    return (x[..., None] / 255.0 - torch.tensor(mean)) / torch.tensor(std)


def test_pipeline_decoder_input_matches_plain_reference(vit_dir):
    _, est = cli.initialize_sessions(vit_dir, device="cpu")
    assert isinstance(est.encoder, ViTEncoder)
    seen = _tap(est)
    assert len(est.process_images(_masks())) == 2
    crops, seq = seen["crops"][0], seen["seq"][0]
    assert len(seen["seq"]) == 1 and len(crops) >= 4
    assert seq.shape == (len(crops), 16, 24)
    proj = est.projection.requires_grad_(False)
    ref = plain_vit.forward(tensors(TINY_TREE), plain_normalize(
        crops.float(), TINY_VIT.mean, TINY_VIT.std)) @ proj.weight.T + proj.bias
    err = float((seq - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def test_vit_layout_round_trip():
    """The flax layout -> the module's state -> the layout, leaf for leaf
    and bit for bit."""
    sd = encoder_state({"params": TINY_TREE}, "vit_tiny")
    ViTEncoder("vit_tiny", 64, torch.float32).load_state_dict(sd)  # strict
    back = vit_variables(sd, 4)["params"]

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
    same(back, TINY_TREE)


def test_vit_l16_on_meta():
    """vit_l16's module against the layout's leaves, its width, positions
    and operations (``utils.flops``: the patch embedding, the q/k/v, out
    and MLP GEMMs and both attention products), nothing computed."""
    cfg = tconfig.StrokesConfig(encoder_arch="vit_l16", mean=(0.5,) * 3,
                                std=(0.5,) * 3, projection_dim=512)
    with torch.device("meta"):
        enc = make_encoder(cfg)
        n = flops(enc, torch.zeros(1, 224, 224, 3))
        got = enc(torch.zeros(2, 224, 224, 3))
    sd = enc.state_dict()
    lay = layout(16, 1024, 24, 16, 4096, 197)
    assert sum(int(np.prod(s)) for s in _leaves(lay)) == \
        sum(v.numel() for v in sd.values()) == 303_301_632
    assert sd["patch.weight"].shape == (1024, 768)
    assert sd["pos"].shape == (197, 1024) and sd["cls"].shape == (1, 1024)
    assert sd["blocks.23.qkv.weight"].shape == (3072, 1024)
    assert sd["blocks.23.out.weight"].shape == (1024, 1024)
    assert sd["blocks.23.fc1.weight"].shape == (4096, 1024)
    assert "blocks.24.ln1.weight" not in sd and enc.heads == 16
    assert enc.out_features == encoder_width("vit_l16") == 1024
    assert enc.positions == 196 and got.shape == (2, 196, 1024)
    assert n == VIT_L16_FLOPS


@pytest.mark.parametrize("arch", ["vit_tiny", "tiny"])
def test_vit_span_and_token_counter(vit_dir, tmp_path, arch):
    """Under a profile a ViT opens ``sd.strokes.encode.vit`` inside
    ``sd.strokes.encode`` and counts rows x tokens; a ResNet neither."""
    if arch == "vit_tiny":
        _, est = cli.initialize_sessions(vit_dir, device="cpu")
    else:
        est = StrokeEstimator(TINY_RESNET, device="cpu")
    seen = _tap(est)
    est.process_images(_masks()[:1])   # spans seen with no profile: the
    seen["crops"].clear()              # next profile starts them anew
    with profile(activities=[ProfilerActivity.CPU]):
        est.process_images(_masks())
    recs = tp.SPANS.records()
    counts = tp.COUNTERS.snapshot()
    vit = [r for r in recs if r.name == "sd.strokes.encode.vit"]
    if arch == "tiny":
        assert not vit and "encoder_tokens" not in counts
        return
    encode = {r.id for r in recs if r.name == "sd.strokes.encode"}
    assert len(vit) == 1 and vit[0].parent in encode
    assert counts["encoder_tokens"] == len(seen["crops"][0]) * 17


@pytest.mark.parametrize("case", ["int8", "encode_image_size", "onnx",
                                  "train", "unknown"])
def test_vit_refusals_name_the_arch(case, tmp_path):
    vit = TINY_VIT
    if case == "int8":
        with pytest.raises(ValueError, match="vit_tiny"):
            StrokeEstimator(dataclasses.replace(vit, quant="int8"),
                            device="cpu")
    elif case == "encode_image_size":
        with pytest.raises(ValueError, match="vit_tiny.*encode_image_size"):
            StrokeEstimator(dataclasses.replace(vit, encode_image_size=14),
                            device="cpu")
    elif case == "onnx":
        from stroke_derenderer_tpu_torch.weights.graph_export import (
            export_encoder_graph,
        )
        with pytest.raises(ValueError, match="encoder_arch 'vit_tiny'"):
            export_encoder_graph(vit, {"params": TINY_TREE},
                                 tmp_path / "encoder.onnx")
    elif case == "train":
        from stroke_derenderer_tpu_torch.train.loop import train_captioner
        with pytest.raises(ValueError, match="encoder_arch 'vit_tiny'"):
            train_captioner(dataclasses.replace(vit, projection_dim=0), 1, 2,
                            tmp_path, device="cpu")
    else:
        with pytest.raises(ValueError, match="encoder_arch 'vit_g14'"):
            make_encoder(dataclasses.replace(vit, encoder_arch="vit_g14"))

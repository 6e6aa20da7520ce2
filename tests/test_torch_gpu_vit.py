"""ViT-L/16 on a CUDA card (marker ``gpu``): the port's encoder at its
published widths against ``tests/plain_vit.py`` in float32 (TF32 off), in
bf16 and in float32, with float8 activations failing the bf16 bound; and
a ``vit_l16`` model directory through the normal entry points,
``cli.initialize_sessions`` then ``process_images`` (``--batch``),
``process_image`` (per image) and the server's batch worker, greedy (K1)
and beam (K2). Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_vit.py
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

import plain_vit
from stroke_derenderer_tpu_torch import cli, serve
from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu_torch.io import decode_png, encode_png, to_rgb
from stroke_derenderer_tpu_torch.models.vit import ViTEncoder
from stroke_derenderer_tpu_torch.weights import (
    encoder_state, materialize_model_dir,
)
from test_torch_vit import draw, fp8, layout

REPO = Path(__file__).resolve().parent.parent
VIT_L16 = StrokesConfig(encoder_arch="vit_l16", mean=(0.5,) * 3,
                        std=(0.5,) * 3, projection_dim=512)
# bf16 against the float32 reference over 24 blocks: the largest error
# over the largest output (see test_torch_vit: 8 bits a rounding, ~10
# roundings a block).
BF16_TOL = 0.05


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tensors(tree, dev):
    return {k: _tensors(v, dev) if isinstance(v, dict)
            else torch.from_numpy(v).to(dev) for k, v in tree.items()}


@pytest.mark.gpu
def test_vit_l16_matches_plain_reference_on_the_card():
    dev = _card()
    tree = draw(layout(16, 1024, 24, 16, 4096, 197),
                torch.Generator().manual_seed(16))
    x = torch.rand(32, 224, 224, 3, generator=torch.Generator().manual_seed(
        17)).to(dev) * 2 - 1
    tw = _tensors(tree, dev)
    with torch.no_grad():
        ref = plain_vit.forward(tw, x)
        low = plain_vit.forward(tw, x, act=fp8)
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            port = ViTEncoder("vit_l16", 224, dtype).to(dev).eval()
            port.load_state_dict(encoder_state({"params": tree}, "vit_l16"))
            errs[dtype] = port(x) - ref
            del port
    top = float(ref.abs().max())

    def rel(e):
        rows = e.flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
        return float(e.abs().max()) / top, float(rows.mean())
    readings = {"bf16": rel(errs[torch.bfloat16]),
                "float32": rel(errs[torch.float32]), "fp8": rel(low - ref)}
    print(json.dumps({"vit_l16_err": readings,
                      "card": torch.cuda.get_device_name(0)}))
    assert readings["float32"][0] <= 1e-4
    assert readings["bf16"][0] <= BF16_TOL < readings["fp8"][0]


def _lines():
    paths = sorted((REPO / "examples" / "real_data").glob("real0*_line_*.png"))
    paths = [p for p in paths if "_BINARIZED" not in p.name][:3]
    return [to_rgb(decode_png(p.read_bytes())) for p in paths]


@pytest.fixture(scope="module")
def vit_dir(tmp_path_factory):
    _card()   # before 303 M parameters are drawn on the host
    d = tmp_path_factory.mktemp("vit_l16")
    materialize_model_dir(d, BinarizerConfig(), VIT_L16)
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_vit_l16_model_dir_on_the_normal_path(vit_dir, decode):
    dev = _card()
    binarizer, est = cli.initialize_sessions(
        vit_dir, device=dev, se_overrides={"decode": decode, "beam_size": 3,
                                            "max_length": 48})
    assert isinstance(est.encoder, ViTEncoder)
    assert est.encoder.patch.weight.dtype == torch.bfloat16
    imgs = _lines()
    # The random UNet's masks mean nothing: the lines' own dark pixels.
    assert len(binarizer.binarize_images(imgs)) == len(imgs)
    masks = [im.mean(-1) < 128 for im in imgs]
    batched = est.process_images(masks)
    single = [est.process_image(m) for m in masks]
    assert len(batched) == len(single) == len(imgs)
    assert sum(len(s) for s in batched) > 0 and sum(len(s) for s in single) > 0

    worker = serve.BatchWorker(binarizer, est, window_s=0.05)
    worker.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(worker))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=300)
        conn.request("POST", "/derender", body=encode_png(imgs[0]))
        r = conn.getresponse()
        assert r.status == 200, r.read()
        assert "strokes" in json.loads(r.read())
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        worker.close()
        worker.join(30)
    print(json.dumps({"decode": decode,
                      "glyph_strokes": [len(s) for s in batched],
                      "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))

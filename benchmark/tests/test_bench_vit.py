"""The ViT family, ``encoders/vit.py``, and the cell ``vit_l16.batch_greedy``:
its operations against ``FlopCounterMode``, its leaves through the draw
and the msgpack files, the lookup by name, its widths against the
published ones, its reference against the program's ViT, and a whole run
of the cell on the CPU at the ViT's tiny size (the check passes, a planted
fault fails it, the cell's readers read). The controls and the UNet's
identity with ``upstream``'s at the cell's own size run on the card only."""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import encoders
import run as bench_run
from harness import cell as cells, page_batch, weights
from harness.cell import BENCH, ROOT
from reference import models, msgpack
from stroke_derenderer_tpu_torch.models.vit import ViTEncoder
from stroke_derenderer_tpu_torch.pipeline import strokes
from stroke_derenderer_tpu_torch.weights import encoder_state

CELL = "vit_l16.batch_greedy"
TINY = {"encoder_arch": "vit_tiny", "image_size": 64}
TINY_TRAFFIC = {"lines_per_call": 2, "pool_lines": 4, "pool_seed": 9,
                "crops_per_line": [1, 2], "warmup_calls": 1, "min_calls": 1,
                "check_calls": 1, "trace_from": 0, "trace_calls": 1}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("s", [TINY, TINY | {"image_size": 32},
                               {"encoder_arch": "vit_l16", "image_size": 224}])
def test_flops_match_flop_counter(s):
    vit = encoders.family(s["encoder_arch"])
    tree = _meta_tree(vit.shapes(s))
    with torch.device("meta"):
        with FlopCounterMode(display=False) as fc:
            vit.forward(tree, torch.zeros(2, s["image_size"], s["image_size"], 3))
    assert fc.get_total_flops() == 2 * vit.flops(s)
    if s["encoder_arch"] == "vit_l16":
        assert vit.flops(s) == 123_107_377_152


def _meta_tree(shapes):
    return {k: _meta_tree(v) if isinstance(v, dict) else torch.zeros(v, device="meta")
            for k, v in shapes.items()}


def test_shapes_round_trip_draw_and_msgpack(tmp_path):
    vit = encoders.family("vit_tiny")
    shapes = vit.shapes(TINY)
    drawn = _np_tree(weights.draw(shapes, torch.Generator().manual_seed(4), "cpu"))
    assert weights._shapes(drawn) == shapes
    msgpack.write(weights._split_stats(drawn), tmp_path / "enc.msgpack")
    back = models.merged(msgpack.read(tmp_path / "enc.msgpack"))

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
    same(back, drawn)
    # Fan-in by the first axis of q, k and v: 1/sqrt(hidden).
    q = drawn["Block_0"]["query"]["kernel"]
    assert q.std() == pytest.approx(64 ** -0.5, rel=0.1)
    assert drawn["Block_1"]["LayerNorm_1"]["scale"].tolist() == [1.0] * 64


def test_family_lookup():
    assert encoders.family("vit_l16").__name__ == "bench_encoder_vit"
    assert encoders.family("resnet18").__name__ == "bench_encoder_resnet"
    assert encoders.family("resnet50").__name__ == "bench_encoder_resnet"


def test_config_holds_the_published_widths():
    cfg = json.loads((BENCH / "configs" / "vit_l16.json").read_text())
    pub, s = cfg["encoder_published"], cfg["strokes"]
    patch, hidden, depth, heads, mlp = encoders.family("vit_l16").ARCHS["vit_l16"]
    assert (patch, hidden, depth, heads, mlp) == (
        pub["patch_size"], pub["hidden_size"], pub["num_hidden_layers"],
        pub["num_attention_heads"], pub["intermediate_size"])
    assert s["image_size"] == pub["image_size"] and s["encode_image_size"] == 224 // patch
    assert s["mean"] == pub["image_mean"] and s["std"] == pub["image_std"]
    assert cfg["reduced"] == [] and s["projection_dim"] == 512
    up = json.loads((BENCH / "configs" / "upstream.json").read_text())
    assert cfg["binarizer"] == up["binarizer"] and cfg["weights_seed"] == up["weights_seed"]


def test_reference_matches_program():
    vit = encoders.family("vit_tiny")
    tree = _np_tree(weights.draw(vit.shapes(TINY), torch.Generator().manual_seed(6), "cpu"))
    port = ViTEncoder("vit_tiny", 64, torch.float32).eval()
    port.load_state_dict(encoder_state(tree, "vit_tiny"))
    x = torch.randn(3, 64, 64, 3)
    with torch.no_grad():
        want = port(x)
        got = vit.forward(models.to_tensors(tree, "cpu"), x)
        with models.low_precision("fp8"):
            low = vit.forward(models.to_tensors(tree, "cpu"), x)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    assert float((low - got).norm() / got.norm()) > 0.02


def tiny_cell():
    cell = cells.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["strokes"]["encoder_arch"] = "vit_tiny"
    return dataclasses.replace(cell, config=cfg, traffic=cell.traffic | TINY_TRAFFIC)


@pytest.mark.parametrize("fault", [None, "token"])
def test_tiny_run_of_the_cell(fault):
    """The cell on the CPU with the tiny ViT in place of vit_l16: sound, it
    passes the check and its readers read; with one token moved it does not."""
    cell = tiny_cell()
    torch.set_num_threads(4)
    orig = strokes.fused_greedy_decode

    def moved(decoder, seq, max_length, *args):
        toks = orig(decoder, seq, max_length, *args).clone()
        toks[0, 1] = 3 + (int(toks[0, 1]) + 101) % 448
        return toks
    if fault:
        strokes.fused_greedy_decode = moved
    try:
        res = page_batch.run(cell, 2**31 + 91, 0.05, fault is None, "cpu", time.perf_counter())
    finally:
        strokes.fused_greedy_decode = orig
    _, ok = bench_run.compared(res["numbers"], cell.limits)
    if fault:
        assert not ok, res["numbers"]
        return
    assert ok, res["numbers"]
    layer = res["per_layer"]
    assert layer["vit_token_fill"]["value"] == 100.0
    assert layer["vit_enqueue_ms_per_img"]["value"] > 0
    assert "k1_roofline" not in layer or layer["k1_roofline"]["value"] >= 0
    assert cells.forbidden_modules(sys.modules) == []


@pytest.mark.gpu
def test_unet_is_upstreams_on_the_card(tmp_path):
    """The cell's drawn UNet equals ``upstream``'s bit for bit on the card,
    so ``mask_px_share`` is ``upstream.batch_greedy``'s number."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = {}
    for name in ("upstream", "vit_l16"):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        weights.random_model_dir(cfg, tmp_path / name, "cuda")
        got[name] = (tmp_path / name / "binarizer.msgpack").read_bytes()
    assert got["upstream"] == got["vit_l16"]


@pytest.mark.gpu
def test_fp8_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELL,
                        "--seed", str(2**31 + 4242), "--seconds", "5", "--trace", "0",
                        "--control", "fp8"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False

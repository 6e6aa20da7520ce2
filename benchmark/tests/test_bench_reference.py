"""The plain reference against the program on the CPU, in float32, at small
sizes: the networks on the committed weights and on drawn batch-norm
ones, the partition and its crops, and the polylines."""

import numpy as np
import pytest
import torch

import encoders
from harness import lines, weights
from harness.cell import ROOT
from reference import geometry, models
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder, decode_step
from stroke_derenderer_tpu_torch.models.encoder import (
    ResNetEncoder, encode_postprocess,
)
from stroke_derenderer_tpu_torch.models.unet import AttentionUNet
from stroke_derenderer_tpu_torch.ops.device_partition import (
    gather_crops, plan_partitions,
)
from stroke_derenderer_tpu_torch.pipeline.strokes import (
    StrokeEstimator, compute_partitions,
)
from stroke_derenderer_tpu_torch.config import StrokesConfig
from stroke_derenderer_tpu_torch.weights import (
    from_flax_decoder, from_flax_encoder, from_flax_unet,
)

DEMO = ROOT / "models_demo"
CFG = {"strokes": {"projection_dim": 0}}


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}


def _stats_split(tree):
    return weights._split_stats(tree)


@pytest.fixture(scope="module")
def demo():
    return weights.read_model_dir(DEMO, CFG)


@pytest.fixture(scope="module")
def line_masks():
    crops = lines.load_crops(ROOT)
    params = {"crops_per_line": [1, 6], "height_px": [48, 96],
              "gap_x_height": [0.2, 0.6], "pool_lines": 6, "pool_seed": 3}
    return lines.pool(crops, params, 128)


def _unet_case(tree, feats, bottleneck, norm):
    port = AttentionUNet(feats, bottleneck, 3, dtype=torch.float32, norm=norm).eval()
    port.load_state_dict(from_flax_unet(_stats_split(tree), len(feats)))
    tiles = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 32, 64, 3)),
                            dtype=torch.uint8)
    with torch.no_grad():
        want = port(tiles.float() / 255.0)[..., 0]
        got = models.unet(models.to_tensors(tree, "cpu"), tiles)
    assert torch.allclose(got, want, atol=2e-5)


def test_unet_matches_program(demo):
    _unet_case(demo["binarizer"], (16, 32, 64), 128, "group")
    drawn = _np_tree(weights.draw(weights.unet_shapes((8, 16), 32, 3, "batch"),
                                  torch.Generator().manual_seed(1), "cpu"))
    _unet_case(drawn, (8, 16), 32, "batch")


@pytest.mark.parametrize("arch,norm", [("resnet18", "group"), ("resnet50", "batch")])
def test_encoder_matches_program(demo, arch, norm):
    fam = encoders.family(arch)
    if arch == "resnet18":
        tree = demo["encoder"]
    else:
        tree = _np_tree(weights.draw(fam.shapes({"encoder_arch": arch, "encoder_norm": norm}),
                                     torch.Generator().manual_seed(2), "cpu"))
    kind = "basic" if arch == "resnet18" else "bottleneck"
    port = ResNetEncoder(arch, dtype=torch.float32, norm=norm).eval()
    port.load_state_dict(from_flax_encoder(_stats_split(tree), kind))
    x = torch.randn(2, 224, 224, 3)
    with torch.no_grad():
        want = encode_postprocess(port(x), 14)
        got = fam.forward(models.to_tensors(tree, "cpu"), x)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_decoder_step_matches_program(demo):
    tree = demo["decoder"]
    port = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.float32)
    port.load_state_dict(from_flax_decoder(tree))
    enc = torch.rand(3, 196, 512)
    ref = models.Decoder(models.to_tensors(tree, "cpu"), enc)
    with torch.no_grad():
        h, c = port.init_state(enc)
        assert torch.allclose(ref.h, h, atol=1e-5) and torch.allclose(ref.c, c, atol=1e-5)
        tok = torch.tensor([1, 7, 200])
        want, h2, c2 = decode_step(port.weights(torch.float32), enc,
                                   port.project_encoding(enc), port.embed(tok), h, c)
        got, rh, rc = ref.step(tok, ref.h, ref.c)
    assert torch.allclose(got, want, atol=1e-4)
    assert torch.allclose(rh, h2, atol=1e-5)


def test_partition_matches_program(line_masks):
    cfg = StrokesConfig()
    for ln in line_masks:
        mask = ln.mask.astype(np.uint8)
        ref = geometry.partition(mask, 2, 224)
        host = compute_partitions(mask * 255, cfg)
        assert len(ref) == len(host) > 0
        for (crop, t1, r, t2), h in zip(ref, host):
            assert np.array_equal(crop, h["image"])
            assert t1 == h["translate1"] and r == h["ratio"] and t2 == h["translate2"]
        # The device gather (run here on the CPU) cuts the same crops to
        # within the rounding of a half grey level.
        plan = plan_partitions(mask, 2, 224)
        dev = gather_crops(torch.as_tensor(plan.gid_img.astype(np.int16)),
                           tuple(torch.as_tensor(getattr(plan, k)) for k in plan.COORD_KEYS))
        assert (dev - torch.as_tensor(np.stack([c for c, *_ in ref])).float()).abs().max() <= 1


def test_polylines_match_program(line_masks):
    est = StrokeEstimator.__new__(StrokeEstimator)
    est.config = StrokesConfig()
    rng = np.random.default_rng(4)
    for ln in line_masks:
        parts = geometry.partition(ln.mask.astype(np.uint8), 2, 224)
        toks = rng.integers(0, 451, (len(parts), 40)).astype(np.int32)
        toks[:, 0] = 1
        want = est.process_tokens(toks, [{"translate1": t1, "ratio": r, "translate2": t2}
                                         for _, t1, r, t2 in parts])
        got = geometry.sort_strokes([s for (_, t1, r, t2), tk in zip(parts, toks)
                                     for s in geometry.glyph_strokes(tk, 224, t1, r, t2)])
        assert len(got) == len(want)
        for (x, y), (wx, wy) in zip(got, want):
            assert np.array_equal(x, wx) and np.array_equal(y, wy)


def test_beam_sums_match_program(demo):
    """The check's beam numbers on the program's plain beam search in
    float32: the written beam is the one its scores rank first, and each
    beam's score is the reference's sum of its log-probabilities."""
    from harness import check
    from stroke_derenderer_tpu_torch.kernels.fused_beam import (
        fused_beam_decode_plain, select_beam,
    )
    tree = demo["decoder"]
    port = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.float32)
    port.load_state_dict(from_flax_decoder(tree))
    enc = torch.rand(3, 196, 512, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        h, c = port.init_state(enc)
        preds, score, lens = fused_beam_decode_plain(
            enc, port.project_encoding(enc), h, c, port.weights(torch.float32), 12, 3)
        tok = select_beam(preds, score, lens)
        got = check._beam_numbers(models.to_tensors(tree, "cpu"), enc, tok, preds.long(),
                                  score, lens, 0.0)
        worse = check._beam_numbers(models.to_tensors(tree, "cpu"), enc, tok, preds.long(),
                                    score - 0.5, lens, 0.0)
    assert got["beam_pick_off"] == 0 and got["beam_pick_gap"] == 0
    assert got["beam_score_err"] < 1e-3
    assert worse["beam_score_err_mean"] > 0.49


def test_fp8_control_rounds_every_operand(demo):
    """Under ``low_precision("fp8")`` a matmul's operands lie on the float8
    e4m3 grid of their scale, and the features move by a few percent."""
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    with models.low_precision("fp8"):
        q = models._q(x)
    scale = x.abs().amax() / models.FP8_MAX
    assert torch.equal((q / scale).to(torch.float8_e4m3fn).float() * scale, q)
    assert 0 < float((q - x).norm() / x.norm()) < 0.05
    crops = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 64, 64)),
                            dtype=torch.float32)
    enc = models.to_tensors(demo["encoder"], "cpu")
    imgs = models.normalize_crops(crops, [0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    resnet = encoders.family("resnet18").forward
    ref = resnet(enc, imgs)
    with models.low_precision("fp8"):
        low = resnet(enc, imgs)
    assert 0.005 < float((low - ref).norm() / ref.norm()) < 0.2

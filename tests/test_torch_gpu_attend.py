"""K1 and K2's attention phases on a card (marker ``gpu``): the scores and
the attended sum of ``csrc/decode_step.cuh``, tiled by image, against the
plain versions, at the shapes their tiling turns on: K = 1, 5 and 17
(groups of 8, 8 and 1 beams), P not a multiple of the four positions of a
score task, E = 2048, B = 1 and fewer rows than blocks (the split tiling),
a page's 2,400 beams of real glyphs whose images finish at different steps
(rows drop out mid-launch), and the launch's record of split steps against
``fused_decode.att_tiling`` at each step's live groups. Each test decides
in its body whether a card is there and skips without one; on the CPU all
skip (no tier-1 time). This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_attend.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import PAD
from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder

REPO = Path(__file__).resolve().parent.parent


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stroke_derenderer_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _shipped_decoder(dtype, dev):
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    dec = AttentiveDecoder(451, 512, 512, 512, 512, dtype=dtype)
    dec.load_state_dict(tw.from_flax_decoder(tree))
    return dec.to(dev)


def _wide_decoder(dtype, dev):
    """A random decoder that reads a ResNet-50's 2048 features."""
    from stroke_derenderer_tpu_torch.config import StrokesConfig
    _, dec = tw.init_strokes(StrokesConfig(
        encoder_arch="resnet50", compute_dtype=str(dtype).split(".")[1]),
        seed=3)
    return dec.to(dev)


def _enc(b, p, e, dt, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.maximum(rng.normal(1.0, 1.5, (b, p, e)),
                                       0).astype(np.float32)).to(dev, dt)


def _launch(name, dec, enc, k, steps):
    """One K1 ("fused_decode") or K2 launch; its tensors and the inputs."""
    ep = dec.project_encoding(enc).contiguous()
    h, c = (t.contiguous() for t in dec.init_state(enc))
    b = enc.shape[0]
    out = {"preds": torch.full((b, k, steps), PAD, dtype=torch.int32,
                               device=enc.device),
           "score_out": torch.zeros((b, k), device=enc.device),
           "lens_out": torch.zeros((b, k), dtype=torch.int32,
                                   device=enc.device)}
    launched = fd.launch_step_kernel(
        name, enc, ep, h, c, fd.pack_step_weights(dec.weights(enc.dtype)), k,
        steps, out)
    torch.cuda.synchronize()
    return launched, (enc, ep, h, c)


def _check_record(launched, live_steps, k, e):
    """The launch's record: the steps it ran, and those whose attended sum
    split a group over blocks, as att_tiling gives them for the live groups
    of each step (a row or image with s steps is live at steps 0 .. s - 1).
    Returns the split steps."""
    grid = launched["rows"].shape[0]
    cpi = -(-k // min(k, fd.ATT_G))
    live = live_steps.cpu().long()
    ran = int(live.max())
    want = sum(fd.att_tiling(int((live > t).sum()) * cpi, e, grid)["split"]
               for t in range(ran))
    split, got_ran = (int(x) for x in launched["astat"].cpu())
    assert (split, got_ran) == (want, ran)
    return split


# (K, images, positions, steps): the golden rows at one image; fewer rows
# than blocks with P = 13; K = 5 at P = 13; K = 17 (groups of 8, 8, 1).
CASES = [(1, 1, 196, 384), (1, 6, 13, 384), (5, 2, 13, 384),
         (17, 2, 196, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,b,p,steps", CASES)
def test_attention_phases_match_the_plain_versions(dtype, k, b, p, steps):
    """K1 (k = 1) or K2 against its plain version on the shipped decoder:
    tokens and lengths identical, scores within 1e-5 relative, and the
    split steps those att_tiling predicts."""
    dev = _card()
    dt = getattr(torch, dtype)
    dec = _shipped_decoder(dt, dev)
    enc = _enc(b, p, 512, dt, dev, 100 * k + b + p)
    name = "fused_decode" if k == 1 else "fused_beam"
    launched, args = _launch(name, dec, enc, k, steps)
    w = dec.weights(dt)
    if k == 1:
        got = launched["preds"][:, 0]
        want = fd.fused_greedy_decode_plain(*args, w, steps)
        assert torch.equal(got, want)
        _check_record(launched, fd.greedy_steps(got, steps), 1, 512)
        return
    preds, score, lens = fb.fused_beam_decode_plain(*args, w, steps, k)
    assert torch.equal(launched["preds"], preds)
    assert torch.equal(launched["lens_out"], lens)
    torch.testing.assert_close(launched["score_out"], score, rtol=1e-5,
                               atol=0)
    _check_record(launched, launched["steps"], k, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_phases_at_encoder_width_2048(dtype):
    """K2 at K = 5 on a decoder that reads 2048 features (phase C in four
    passes of 512 columns a group, or split) against its plain version."""
    dev = _card()
    dt = getattr(torch, dtype)
    dec = _wide_decoder(dt, dev)
    assert dec.enc_att_w.shape[0] == 2048
    enc = _enc(3, 196, 2048, dt, dev, 4)
    launched, args = _launch("fused_beam", dec, enc, 5, 96)
    preds, score, lens = fb.fused_beam_decode_plain(*args, dec.weights(dt),
                                                    96, 5)
    assert torch.equal(launched["preds"], preds)
    assert torch.equal(launched["lens_out"], lens)
    _check_record(launched, launched["steps"], 5, 2048)


def _page_glyphs(dev, n):
    """The encoder features of n glyph crops: the 197 glyphs of the golden
    image and the pseudo-real lines, in bfloat16 by models_demo's encoder,
    repeated to n."""
    from stroke_derenderer_tpu_torch import cli
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    binarizer, est = cli.initialize_sessions(REPO / "models_demo", device=dev)
    inputs = [REPO / "tests" / "golden" / "golden_input.png"] + sorted(
        q for q in (REPO / "data_pseudo_real").glob("*.png")
        if not q.stem.endswith("_BINARIZED"))
    imgs = [img for img, _ in cli.load_images(inputs)]
    with torch.inference_mode():
        masks = [m[:, :, 0] > 127 for m in binarizer.binarize_images(imgs)]
        crops = est._gather_batch(masks)[0]
        seq = encode_postprocess(est.encoder(est._normalize_raw(crops)),
                                 est.config.encode_image_size)
    reps = -(-n // seq.shape[0])
    return seq.repeat(reps, 1, 1)[:n].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_page_of_beams_whose_images_finish_apart(dtype):
    """K2 at a page's 480 images x 5 beams and K1 at its 480 rows, on real
    glyphs: images finish at different steps, so rows drop out mid-launch
    and the tail of the launch takes the split tiling; tokens and lengths
    identical to the plain versions, and the record as att_tiling gives
    it."""
    dev = _card()
    dt = getattr(torch, dtype)
    dec = _shipped_decoder(dt, dev)
    enc = _page_glyphs(dev, 480).to(dt)
    launched, args = _launch("fused_beam", dec, enc, 5, 384)
    w = dec.weights(dt)
    preds, score, lens = fb.fused_beam_decode_plain(*args, w, 384, 5)
    assert torch.equal(launched["preds"], preds)
    assert torch.equal(launched["lens_out"], lens)
    steps = launched["steps"].cpu()
    assert int(steps.min()) < int(steps.max())  # rows dropped out
    assert _check_record(launched, steps, 5, 512) > 0
    launched, args = _launch("fused_decode", dec, enc, 1, 384)
    got = launched["preds"][:, 0]
    assert torch.equal(got, fd.fused_greedy_decode_plain(*args, w, 384))
    _check_record(launched, fd.greedy_steps(got, 384), 1, 512)

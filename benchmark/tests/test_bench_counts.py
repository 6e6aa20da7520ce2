"""The operation and byte counts against FlopCounterMode and hand sums."""

import torch
from torch.utils.flop_counter import FlopCounterMode

import counts
import encoders
from harness import weights
from reference import models


def _counted(fn, *args):
    with FlopCounterMode(display=False) as c:
        fn(*args)
    return c.get_total_flops()


def _tree(shapes):
    return weights.draw(shapes, torch.Generator().manual_seed(0), "cpu")


def test_unet_flops():
    for feats, b, hw in (((16, 32, 64), 128, (32, 64)), ((8, 16), 32, (16, 32))):
        p = _tree(weights.unet_shapes(feats, b, 3, "group"))
        tiles = torch.zeros((2,) + hw + (3,), dtype=torch.uint8)
        assert _counted(models.unet, p, tiles) == 2 * counts.unet_flops(feats, b, 3, *hw)


def test_resnet_flops():
    for arch in ("resnet18", "resnet50"):
        fam = encoders.family(arch)
        s = {"encoder_arch": arch, "encoder_norm": "batch", "image_size": 64}
        p = _tree(fam.shapes(s))
        # The counted call repeats the 7x7 map to 14x14 after the blocks;
        # that copy is no operation.
        assert _counted(fam.forward, p, torch.zeros(1, 64, 64, 3)) == fam.flops(s)


def test_decoder_flops():
    p, e, a, h, d, v = 9, 12, 10, 8, 6, 23
    tree = _tree(weights.decoder_shapes(v, d, a, h, e))
    enc = torch.zeros(3, p, e)
    init = _counted(models.Decoder, tree, enc)
    assert init == 3 * counts.decoder_row_flops(p, e, a, h)
    dec = models.Decoder(tree, enc)
    step = _counted(dec.step, torch.zeros(3, dtype=torch.long), dec.h, dec.c)
    assert step == 3 * counts.decoder_step_flops(p, e, a, h, d, v)


def test_decode_cost_by_hand():
    c = counts.decode_cost(rows=2, steps=[3, 5], k=1, p=4, e=8, a=8, hdim=8, d=8, v=10,
                           max_length=16, dtype="bfloat16")
    # 2HA + 2HE + 2(D+E)4H + 2H4H + 2HV + 3PA + 2PE
    step = (2 * 8 * 8 + 2 * 8 * 8 + 2 * 16 * 32 + 2 * 8 * 32 + 2 * 8 * 10
            + 3 * 4 * 8 + 2 * 4 * 8)
    assert c["flops"] == 8 * step
    weights_b = (8 * 8 + 8 + 8 + 1 + 8 * 8 + 8 + 16 * 32 + 8 * 32 + 32 + 10 * 8) * 2 + (8 * 10 + 10) * 4
    io = 2 * 4 * 16 * 2 + 2 * 2 * 8 * 2 + 2 * 16 * 4
    assert c["bytes_once"] == weights_b + io
    assert c["bound_s"] == max((weights_b + io) / counts.HBM_BYTES_PER_S,
                               8 * step / counts.PEAK_FLOPS["bfloat16"])
    beam = counts.decode_cost(rows=2, steps=[3, 5], k=5, p=4, e=8, a=8, hdim=8, d=8, v=10,
                              max_length=16, dtype="bfloat16")
    assert beam["flops"] == 8 * 5 * (step + 5 * 10)

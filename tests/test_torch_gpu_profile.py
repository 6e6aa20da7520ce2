"""Tests of ``utils/profiling``, the group-id packing and the native host
ops that need a CUDA card (marker ``gpu``); each skips without one. This
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_profile.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.io import read_png
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
from stroke_derenderer_tpu_torch.ops import connected
from stroke_derenderer_tpu_torch.ops import device_partition as dp
from stroke_derenderer_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stroke_derenderer_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _golden_mask() -> np.ndarray:
    return read_png(REPO / "tests" / "golden" /
                    "expected_BINARIZED.png")[:, :, 0] > 0


@pytest.mark.gpu
def test_device_trace_sees_a_k1_launch(tmp_path):
    """A trace around one K1 launch holds device intervals: the card's busy
    time is positive and below the traced wall time."""
    import time
    dev = _card()
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    dec = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.bfloat16)
    dec.load_state_dict(tw.from_flax_decoder(tree))
    dec = dec.to(dev)
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(np.maximum(rng.normal(1.0, 1.5, (4, 196, 512)),
                                      0).astype(np.float32)).to(
        dev, torch.bfloat16)
    fd.fused_greedy_decode(dec, enc, 384)  # build and warm up
    torch.cuda.synchronize()
    before = fd.launch_count
    with profiling.device_trace(tmp_path, dev):
        t = time.perf_counter()
        fd.fused_greedy_decode(dec, enc, 384)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    assert fd.launch_count == before + 1
    busy = profiling.chip_busy_ms(tmp_path)
    assert busy is not None and 0 < busy <= wall_ms


@pytest.mark.gpu
@pytest.mark.parametrize("rle", [True, False])
def test_unpack_gid_on_the_card_equals_the_cpu(rle):
    dev = _card()
    mask = _golden_mask()
    plan = dp.plan_partitions(mask, 2, 224)
    for gid, groups in ((plan.gid_img, len(plan.partitions)),
                        (np.stack([plan.gid_img] * 3), 40),
                        (np.stack([plan.gid_img] * 2), 300)):
        if gid.shape[-1] % 2:
            gid = np.concatenate([gid, np.full(gid.shape[:-1] + (1,), -1,
                                               np.int16)], axis=-1)
        packed, fmt = dp.pack_gid(gid, groups, allow_rle=rle)
        parts = packed if isinstance(packed, tuple) else (packed,)
        on = [torch.from_numpy(a).to(dev) for a in parts]
        got = dp.unpack_gid(tuple(on) if len(on) > 1 else on[0], fmt)
        want = dp.unpack_gid(tuple(torch.from_numpy(a) for a in parts)
                             if len(parts) > 1 else torch.from_numpy(
                                 parts[0]), fmt)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
        np.testing.assert_array_equal(want.numpy(), gid)


@pytest.mark.gpu
def test_native_cc_on_the_golden_mask():
    """The native CC (built here with g++) on the golden mask: scipy's
    labels, boxes and areas; the device CC on the card the same labels."""
    dev = _card()
    mask = _golden_mask()
    got = connected.connected_components_with_boxes(mask, with_area=True)
    want = connected.connected_components_with_boxes(mask, with_area=True,
                                                     backend="scipy")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    labels, num = connected.connected_components_device(
        torch.from_numpy(mask).to(dev))
    assert labels.device.type == "cuda"
    np.testing.assert_array_equal(labels.cpu().numpy(), got[0])
    assert num == len(got[1]) > 0

"""The host side of the step engine's tensor-core path (bfloat16 streams;
``csrc/decode_step.cuh``): the exact three-way bfloat16 split of W_fc, the
resident slices each block copies into shared memory, the shared-memory
plan, and which path a launch takes. The kernel itself runs only on a card:
``tests/test_torch_gpu.py`` holds it against its plain version there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.config import PAD
from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder

REPO = Path(__file__).resolve().parent.parent
HEADER = REPO / "stroke_derenderer_tpu_torch" / "csrc" / "decode_step.cuh"

# (E, A, H, D, V): models_demo's decoder, phase onnx's unprojected
# ResNet-50 features (E = 2048), and a tiny model.
WIDTHS = {"models_demo": (512, 512, 512, 512, 451),
          "onnx E=2048": (2048, 512, 512, 512, 451),
          "tiny": (16, 12, 20, 8, 51)}
# Blocks of a launch: an H100's 132 SMs (capped at H), a 114-SM card's;
# the tiny model also on 7 and 1 blocks. (With few blocks a wide model's
# head slice outgrows MAX_LT m-tiles: the plan raises.)
GRIDS = [("models_demo", 132), ("models_demo", 114), ("onnx E=2048", 132),
         ("onnx E=2048", 114), ("tiny", 132), ("tiny", 7), ("tiny", 1)]


def _dims(e, a, hdim, d, v, k=1, p=196):
    return {"B": 3, "P": p, "E": e, "A": a, "H": hdim, "D": d, "V": v, "K": k,
            "max_length": 12}


def _exact_sum(hi, mid, lo):
    return hi.double() + mid.double() + lo.double()


def test_bf16_split_of_the_shipped_head_is_exact():
    """W_fc of models_demo as three bfloat16 parts: their sum is the
    float32 value exactly, in float64 and in float32 ((hi + mid) + lo)."""
    tree = tw.read_msgpack(REPO / "models_demo" / "strokes_decoder.msgpack")
    dec = AttentiveDecoder(451, 512, 512, 512, 512)
    dec.load_state_dict(tw.from_flax_decoder(tree))
    wfc = dec.weights(torch.bfloat16)["wfc"]
    assert wfc.dtype == torch.float32
    hi, mid, lo = fd.split_bf16x3(wfc)
    assert {t.dtype for t in (hi, mid, lo)} == {torch.bfloat16}
    assert torch.equal(_exact_sum(hi, mid, lo), wfc.double())
    assert torch.equal((hi.float() + mid.float()) + lo.float(), wfc)
    assert torch.equal(hi, wfc.to(torch.bfloat16))  # hi is the rounding


def test_bf16_split_is_exact_across_magnitudes():
    """Random magnitudes over 2^-110 .. 2^127 of either sign, values that
    round up to the next power of two, zeros and 3e38. (Below 2^-110 the lo
    part would fall among bfloat16's subnormals; above bfloat16's largest
    finite value, 3.39e38, hi would be infinite.)"""
    rng = np.random.default_rng(0)
    x = (rng.choice([-1.0, 1.0], 200_000) * rng.uniform(1, 2, 200_000)
         * np.exp2(rng.integers(-110, 127, 200_000)))
    edges = [0.0, -0.0, 1.0, -1.0, np.float32(2.0) - np.float32(2.0 ** -22),
             np.float32(1.0) + np.float32(2.0 ** -23), 3.0e38,
             -1.1754943508222875e-38 * 1024, 0.1, -0.3]
    x = torch.from_numpy(np.concatenate([x, edges]).astype(np.float32))
    hi, mid, lo = fd.split_bf16x3(x)
    assert torch.equal(_exact_sum(hi, mid, lo), x.double())


def test_pack_adds_the_split_head_for_bf16_only():
    """pack_step_weights of bfloat16 weights adds mh = [m1; hi; mid; lo],
    column n of W_fc at rows A + E + n, + V, + 2V; float32 weights get
    none (their path reads fc as it is)."""
    e, a, hdim, d, v = WIDTHS["tiny"]
    dec = AttentiveDecoder(v, d, a, hdim, e)
    gen = torch.Generator().manual_seed(1)
    for prm in dec.parameters():
        prm.copy_(torch.randn(prm.shape, generator=gen))
    assert "mh" not in fd.pack_step_weights(dec.weights(torch.float32))
    packed = fd.pack_step_weights(dec.weights(torch.bfloat16))
    mh, m1, fc = packed["mh"], packed["m1"], packed["fc"]
    assert mh.dtype == torch.bfloat16 and mh.is_contiguous()
    assert mh.shape == (a + e + 3 * v, m1.shape[1])
    assert torch.equal(mh[:a + e], m1)
    parts = [mh[a + e + i * v:a + e + (i + 1) * v] for i in range(3)]
    assert torch.equal(_exact_sum(*parts), fc.double())


def _head_columns(plan, b):
    return np.arange(plan["head_start"][b], plan["head_start"][b + 1])


@pytest.mark.parametrize("name,grid", GRIDS)
def test_resident_slices_cover_every_column_once_in_order(name, grid):
    """Block b's resident rows: its units' rows 4j .. 4j + 3 of m3 in
    order, then zeros; its head columns in order, 16 to an m-tile, each
    tile with any W_fc column followed by the mid and lo parts of exactly
    those columns. Over all blocks every m3 row and every head column is
    resident exactly once."""
    e, a, hdim, d, v = WIDTHS[name]
    grid = min(grid, hdim)
    sl = fd.mma_slices(grid, _dims(e, a, hdim, d, v))
    plan = fd.step_plan(grid, a, e, v, hdim)
    assert sl["R3"] % 16 == 0 and sl["RH"] % 16 == 0
    assert sl["m3map"].shape == (grid, sl["R3"])
    assert sl["hmap"].shape == (grid, sl["RH"])
    assert sl["hkind"].shape == (grid, fd.MMA_MAX_LT)
    m3_rows, head_cols = [], []
    for b in range(grid):
        j0, j1 = plan["unit_start"][b], plan["unit_start"][b + 1]
        row = sl["m3map"][b]
        want = np.arange(4 * j0, 4 * j1)
        assert np.array_equal(row[:len(want)], want)
        assert (row[len(want):] == -1).all()
        m3_rows.append(want)
        cols = _head_columns(plan, b)
        kinds = sl["hkind"][b]
        ntiles = -(-len(cols) // 16)
        assert (kinds[:ntiles] > 0).all() and (kinds[ntiles:] == 0).all()
        off = 0
        for t in range(ntiles):
            tile = cols[16 * t:16 * t + 16]
            fc = tile >= a + e
            hi = sl["hmap"][b, off:off + 16]
            assert np.array_equal(hi[:len(tile)], tile)
            assert (hi[len(tile):] == -1).all()
            assert kinds[t] == (3 if fc.any() else 1)
            if kinds[t] == 3:
                for i, part in ((1, v), (2, 2 * v)):
                    got = sl["hmap"][b, off + 16 * i:off + 16 * (i + 1)]
                    assert np.array_equal(got[:len(tile)],
                                          np.where(fc, tile + part, -1))
                    assert (got[len(tile):] == -1).all()
            off += 16 * kinds[t]
        assert (sl["hmap"][b, off:] == -1).all()
        head_cols.append(sl["hmap"][b, :off][
            (sl["hmap"][b, :off] >= 0) & (sl["hmap"][b, :off] < a + e + v)])
    assert np.array_equal(np.concatenate(m3_rows), np.arange(4 * hdim))
    assert np.array_equal(np.sort(np.concatenate(head_cols)),
                          np.arange(a + e + v))


@pytest.mark.parametrize("k", [1, 5, 17])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_shared_memory_plan_fits_a_block(name, k):
    """At 132 blocks (an H100) the tensor-core plan fits the 227 KB a block
    may have, with room for the kernels' static shared variables, and its
    staging keeps every warp within MAXJ jobs; its bytes are those of
    mma_smem_bytes. models_demo stages 128 rows at a time."""
    e, a, hdim, d, v = WIDTHS[name]
    dims = _dims(e, a, hdim, d, v, k)
    grid = min(132, hdim)
    mp = fd.mma_plan(grid, dims)
    assert mp["smem"] == fd.mma_smem_bytes(dims, mp["R3"], mp["RH"],
                                           mp["NT"], mp["KC"])
    assert mp["smem"] <= fd.SMEM_PER_BLOCK - fd.SMEM_STATIC_RESERVE
    assert fd.SMEM_PER_BLOCK == 227 * 1024
    nlog = max(mp["R3"] // 16, int((mp["hkind"] > 0).sum(1).max()))
    assert nlog * mp["NT"] // 8 <= fd.MMA_WARPS * fd.MMA_MAXJ
    assert mp["NT"] % 8 == 0 and mp["KC"] % 16 == 0
    if name == "models_demo":
        assert mp["NT"] == 128


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="do not fit"):
        fd.mma_plan(132, _dims(8192, 512, 512, 512, 451))
    with pytest.raises(ValueError, match="head m-tiles"):
        fd.mma_slices(7, _dims(2048, 512, 512, 512, 451))


def test_constants_match_the_engine_header():
    """The host's copies of the tensor-core path's constants."""
    text = HEADER.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["THREADS"]) // 32 == fd.MMA_WARPS
    for name, value in (("MAXJ", fd.MMA_MAXJ), ("SPAD", fd.MMA_SPAD),
                        ("MAX_LT", fd.MMA_MAX_LT),
                        ("FIXWORDS", fd.MMA_FIXWORDS)):
        assert int(consts[name]) == value, name
    assert fd.MMA_FIXCAP == fd.MMA_WARPS * fd.MMA_MAXJ * 128


def test_the_stream_type_picks_the_path():
    assert fd.ENGINES == {torch.float32: "f64", torch.bfloat16: "mma"}
    assert set(fd.engine_launches) == {"f64", "mma"}
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    assert set(fb.engine_launches) == {"f64", "mma"}


class _Entry:
    def __init__(self):
        self.calls = []

    def __call__(self, dtype, ptrs, dims, grid, stream):
        import ctypes
        self.calls.append((dtype, ctypes.cast(
            ptrs, ctypes.POINTER(ctypes.c_void_p * len(fd.STEP_POINTERS)))
            .contents[:], ctypes.cast(dims, ctypes.POINTER(
                ctypes.c_int * len(fd.STEP_DIMS))).contents[:], grid))
        return 0


@pytest.mark.parametrize("name,k", [("fused_decode", 1), ("fused_beam", 5)])
def test_bf16_launch_hands_the_tensor_core_path_its_arrays(monkeypatch, name,
                                                           k):
    """A bfloat16 launch on the host side: the plan's NT, KC, R3 and RH in
    the dims, the split head, the maps and h and the attended vector in
    bfloat16 set, the float64 path's float32 h and awe null; sizes for B x
    K rows."""
    entry = _Entry()
    grid = 7
    monkeypatch.setattr(fd, "_library", lambda name="fused_decode": (
        None, entry, None))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type(
        "S", (), {"cuda_stream": 0})())

    def fake_grid(name, dt, dims, dev):
        mp = fd.mma_plan(grid, dims)
        plan = {n: torch.from_numpy(t) for n, t in fd.step_plan(
            grid, dims["A"], dims["E"], dims["V"], dims["H"]).items()}
        plan |= {n: torch.from_numpy(mp[n]) for n in ("m3map", "hmap",
                                                       "hkind")}
        return grid, plan | {n: mp[n] for n in ("NT", "KC", "R3", "RH")}

    monkeypatch.setattr(fd, "launch_grid", fake_grid)
    sizes = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    e, a, hdim, d, v = WIDTHS["tiny"]
    dec = AttentiveDecoder(v, d, a, hdim, e, dtype=torch.bfloat16)
    b = 3
    enc = torch.zeros(b, 9, e, dtype=torch.bfloat16)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    out = {"preds": torch.full((b, k, 12), PAD, dtype=torch.int32),
           "score_out": torch.zeros(b, k),
           "lens_out": torch.zeros(b, k, dtype=torch.int32)}
    fd.launch_step_kernel(name, enc, ep, h, c,
                          fd.pack_step_weights(dec.weights(torch.bfloat16)),
                          k, 12, out)
    dtype, ptrs, dims, got_grid = entry.calls[0]
    assert (dtype, got_grid) == (1, grid)
    mp = fd.mma_plan(grid, _dims(e, a, hdim, d, v, k, 9))
    assert dims[9:] == [mp["NT"], mp["KC"], mp["R3"], mp["RH"]]
    got = dict(zip(fd.STEP_POINTERS, ptrs))
    assert {n for n in fd.F64_ONLY if got[n] is None} == set(fd.F64_ONLY)
    assert all(got[n] is not None for n in fd.MMA_ONLY)
    shape = lambda n: sizes[got[n]]
    assert shape("h16") == ((2, b * k, 24), torch.bfloat16)
    assert shape("awe16") == ((b * k, e), torch.bfloat16)
    assert shape("fix") == ((grid, fd.MMA_FIXCAP * fd.MMA_FIXWORDS),
                            torch.int32)
    assert shape("fixstat") == ((grid, 2), torch.int32)


def test_bf16_launch_needs_the_split_head(monkeypatch):
    """bfloat16 streams with weights packed without mh raise rather than
    run another path."""
    monkeypatch.setattr(fd, "launch_grid", lambda name, dt, dims, dev: (
        7, {n: torch.from_numpy(t) for n, t in fd.step_plan(
            7, dims["A"], dims["E"], dims["V"], dims["H"]).items()}))
    e, a, hdim, d, v = WIDTHS["tiny"]
    dec = AttentiveDecoder(v, d, a, hdim, e, dtype=torch.bfloat16)
    enc = torch.zeros(2, 9, e, dtype=torch.bfloat16)
    ep, (h, c) = dec.project_encoding(enc), dec.init_state(enc)
    packed = fd.pack_step_weights(dec.weights(torch.bfloat16))
    del packed["mh"]
    with pytest.raises(ValueError, match="mh"):
        fd.launch_step_kernel("fused_decode", enc, ep, h, c, packed, 1, 12,
                              {"preds": torch.zeros((2, 12),
                                                    dtype=torch.int32)})

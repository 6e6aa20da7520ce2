"""The step engine's attention phases (B, the scores; C, the softmax and
the attended sum; ``csrc/decode_step.cuh``) as index arithmetic on the
host: every (live row, position) pair gets one score and every (live row,
column) of the attended sum is written once, from every position once,
over shapes that include the split tiling of few groups. The functions
below repeat the kernel's index arithmetic (``score_tasks``,
``phase_attend``, ``attend_unit``) and its tiling (``AttTiling``, which
``fused_decode.att_tiling`` computes on the host); ``tests/
test_torch_gpu_attend.py`` holds the kernels against their plain versions
on a card, and the card's record of split steps against ``att_tiling``."""

import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from stroke_derenderer_tpu_torch.kernels import fused_decode as fd

REPO = Path(__file__).resolve().parent.parent
HEADER = REPO / "stroke_derenderer_tpu_torch" / "csrc" / "decode_step.cuh"


def _active_rows(nimg, k, live):
    """The active-row list of a step: the K rows of each live image."""
    return [i * k + j for i in range(nimg) if live(i) for j in range(k)]


def _score_pairs(act, k, p, la, pq):
    """The (row, position) of every score ``score_tasks`` writes, and the
    image whose enc_proj each task reads."""
    per_img = -(-p // pq) * k
    out, reads = [], []
    for t in range(len(act) // k * per_img):
        slot, rem = divmod(t, per_img)
        q, kk = divmod(rem, k)
        r = act[slot * k + kk]
        reads.append((r // k, q))
        for sub in range(pq):  # the lane that writes position pos0 + sub
            if q * pq + sub < p:
                out.append((r, q * pq + sub))
    return out, reads


def _attend_writes(act, k, p, e, grid):
    """One step of ``phase_attend``, every block's units in turn: the
    (row, column) of every sum written, the (row, column) of every sum
    taken, and whether each sum took every position once."""
    g = min(k, fd.ATT_G)
    cpi = -(-k // g)
    tl = fd.att_tiling(len(act) // k * cpi, e, grid)
    cw = tl["cw"]
    nws, tw = fd.MMA_WARPS // cw, 32 * cw
    ns = 2 * nws
    # Warp ws of a column chunk, lane slice ls: positions 2 ws + ls + ns j.
    slices = [2 * ws + ls for ws in range(nws) for ls in range(2)]
    each_once = sorted(q for s in slices for q in range(s, p, ns)) == list(
        range(p))
    written, summed = Counter(), Counter()
    for block in range(grid):
        for u in range(block, tl["units"], grid):
            grp, tile = divmod(u, tl["ntile"])
            slot, chunk = divmod(grp, cpi)
            rows = act[slot * k + chunk * g:][:min(g, k - chunk * g)]
            assert len({r // k for r in rows}) == 1  # one image a group
            c0 = tile * tw
            c1 = e if cw == fd.MMA_WARPS else min(e, c0 + tw)
            for t0 in range(c0, c1, tw):
                cols = [c for cwi in range(cw) for cp in range(16)
                        for c in range(t0 + 32 * cwi + 2 * cp,
                                       t0 + 32 * cwi + 2 * cp + 2) if c < c1]
                summed.update((r, c) for r in rows for c in cols)
                if nws == 1:  # lane slice ls writes rows ls, ls + 2, ...
                    for ls in range(2):
                        written.update((r, c) for rr, r in enumerate(rows)
                                       if rr % 2 == ls for c in cols)
                else:  # the block's threads write the reduced sums
                    written.update((r, t0 + c) for r in rows
                                   for c in range(tw) if t0 + c < c1)
    return written, summed, each_once, tl


# (images, K, P, E, grid, which images live): the golden rows, a page's
# beams, the batched greedy rows, K = 17 over groups of 8, 8 and 1, P not a
# multiple of 4, E = 2048, a 7-block and a 1-block grid, rows dropped out.
SHAPES = [
    (4, 1, 196, 512, 132, "all"), (4, 5, 196, 512, 132, "all"),
    (480, 5, 196, 512, 132, "all"), (197, 1, 196, 512, 132, "all"),
    (197, 5, 196, 512, 132, "odd"), (3, 17, 13, 512, 132, "all"),
    (2, 17, 196, 2048, 132, "all"), (40, 5, 196, 2048, 132, "odd"),
    (1, 1, 13, 16, 7, "all"), (9, 3, 13, 16, 7, "odd"),
    (5, 2, 9, 48, 1, "all"), (60, 5, 196, 512, 132, "every third"),
]
LIVE = {"all": lambda i: True, "odd": lambda i: i % 2 == 1,
        "every third": lambda i: i % 3 == 0}


@pytest.mark.parametrize("nimg,k,p,e,grid,live", SHAPES)
def test_scores_cover_every_live_pair_once(nimg, k, p, e, grid, live):
    """Both tilings of phase B: one score for each (active row, position),
    none for a retired row, and the beams of one image at the same
    positions in neighbouring tasks (one enc_proj read serves them)."""
    act = _active_rows(nimg, k, LIVE[live])
    want = Counter((r, q) for r in act for q in range(p))
    for la, pq in ((8, 4), (32, 1)):
        pairs, reads = _score_pairs(act, k, p, la, pq)
        assert Counter(pairs) == want
        for t in range(0, len(reads), k):
            assert len(set(reads[t:t + k])) == 1


@pytest.mark.parametrize("nimg,k,p,e,grid,live", SHAPES)
def test_attended_sum_covers_every_live_column_once(nimg, k, p, e, grid,
                                                    live):
    """Phase C: each (active row, column) written once, its sum over every
    position once, whichever tiling the step takes."""
    act = _active_rows(nimg, k, LIVE[live])
    written, summed, each_once, _ = _attend_writes(act, k, p, e, grid)
    want = Counter((r, c) for r in act for c in range(e))
    assert written == want and summed == want
    assert each_once


def test_the_tiling_follows_the_live_groups():
    """A page's 480 groups of K2 beams and 197 greedy rows keep a group in
    one unit at E = 512 where that ends soonest; a few groups (the golden
    rows, the tail of a launch) spread a group's columns over blocks, as
    narrow as 32 columns for four groups; E = 2048 at 480 groups takes
    whole groups in four passes."""
    page = fd.att_tiling(480, 512, 132)
    assert (page["cw"], page["units"], page["split"]) == (16, 480, False)
    assert fd.att_tiling(197, 512, 132)["cw"] == 8  # 394 units, 3 a block
    golden = fd.att_tiling(4, 512, 132)
    assert (golden["cw"], golden["ntile"], golden["split"]) == (1, 16, True)
    assert fd.att_tiling(480, 2048, 132) == {"cw": 16, "ntile": 1,
                                             "units": 480, "split": False}
    tiny = fd.att_tiling(3, 16, 7)  # one chunk of 32 columns: never split
    assert tiny["ntile"] == 1 and not tiny["split"]
    for ng in range(1, 700, 7):
        tl = fd.att_tiling(ng, 512, 132)
        assert tl["units"] == ng * tl["ntile"]
        assert tl["cw"] in (1, 2, 4, 8, 16)


def test_the_shared_memory_region_holds_both_phases():
    """att_bytes: phase C's weights of ATT_G rows with one row of partial
    sums; the tensor-core plan reserves it, and phase B's v, at the widths
    of models_demo and of the imported E = 2048 decoder."""
    for k in (1, 5, 17):
        dims = {"B": 3, "P": 196, "E": 512, "A": 512, "H": 512, "D": 512,
                "V": 451, "K": k, "max_length": 12}
        g = min(k, fd.ATT_G)
        assert fd.att_bytes(dims) == 8 * g * 196 + fd.ATT_RED
        for e in (512, 2048):
            mp = fd.mma_plan(132, dims | {"E": e})
            assert mp["smem"] == fd.mma_smem_bytes(
                dims | {"E": e}, mp["R3"], mp["RH"], mp["NT"], mp["KC"])
            assert mp["smem"] <= fd.SMEM_PER_BLOCK - fd.SMEM_STATIC_RESERVE


def test_constants_match_the_engine_header():
    text = HEADER.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    for name in ("ATT_G", "ATT_RED", "ATT_OV"):
        assert int(consts[name]) == getattr(fd, name), name
    assert fd.ATT_RED == fd.MMA_WARPS * 32 * 8
    assert fd.STEP_POINTERS[-1] == "astat"


@pytest.mark.parametrize("astat", [None, (3, 11)])
def test_the_split_counter_is_read_from_the_launch_record(astat):
    """decode_counts adds the launch's steps and its split steps when
    given the record, and nothing otherwise (the plain version has
    none)."""
    steps = torch.tensor([4, 11, 2])
    got = fd.decode_counts(steps, 1, 8, 4, None,
                           None if astat is None else torch.tensor(astat))
    base = {"decode_row_slots": 33, "decode_row_steps": 17}
    if astat is None:
        assert got == base
    else:
        assert got == base | {"decode_attend_split_steps": 3,
                              "decode_attend_steps": 11}

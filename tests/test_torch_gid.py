"""The group-id image's packing for its upload (``ops/device_partition``):
``pack_gid`` gives the JAX package's bytes and format for every format,
``unpack_gid`` (torch, on the packed tensors' device) its ids, and the
crops built from every packing are those of the dense image."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stroke_derenderer_tpu.ops import device_partition as jdp
from stroke_derenderer_tpu_torch.ops import device_partition as tdp


def _line_mask(rng, h, w, n):
    m = np.zeros((h, w), bool)
    for x0 in np.sort(rng.integers(0, w - 30, n)):
        y0 = rng.integers(10, h - 40)
        m[y0:y0 + rng.integers(8, 30), x0:x0 + rng.integers(3, 20)] = True
    return m


def _gid(rng, h, w, n, stack=1, noise=0.0):
    """A (stack, h, w) group-id image of ``n``-island lines, or with
    ``noise`` random ids sprinkled in (a map no run-length code fits)."""
    out = np.full((stack, h, w), -1, np.int16)
    for i in range(stack):
        plan = tdp.plan_partitions(_line_mask(rng, h, w, n), 2, 224)
        if plan is not None:
            out[i] = plan.gid_img
        if noise:
            hit = rng.random((h, w)) < noise
            out[i][hit] = rng.integers(0, max(n, 1), hit.sum())
    return out[0] if stack == 1 else out


def _cases():
    rng = np.random.default_rng(0)
    return {
        # Long background runs: run-length coded.
        "rle line": (_gid(rng, 128, 512, 6), 6, True),
        "rle stack": (_gid(rng, 128, 768, 9, stack=3), 9, True),
        # Dense forms: nibbles (<= 15 groups, even width), int8, int16.
        "nib": (_gid(rng, 128, 512, 6, noise=0.3), 6, True),
        "nib rle off": (_gid(rng, 128, 256, 4), 4, False),
        "i8 odd width": (_gid(rng, 64, 301, 5, noise=0.3), 5, True),
        "i8": (_gid(rng, 64, 512, 40, noise=0.3), 40, True),
        "i16": (_gid(rng, 64, 512, 40, noise=0.3), 200, False),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_pack_and_unpack_match_jax(name):
    gid, groups, rle = CASES[name]
    packed, fmt = tdp.pack_gid(gid, groups, allow_rle=rle)
    j_packed, j_fmt = jdp.pack_gid(gid, groups, allow_rle=rle)
    assert fmt == j_fmt
    assert fmt.split(":")[0] == name.split()[0]
    parts = packed if isinstance(packed, tuple) else (packed,)
    j_parts = j_packed if isinstance(j_packed, tuple) else (j_packed,)
    assert len(parts) == len(j_parts)
    for a, b in zip(parts, j_parts):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    t_in = (tuple(torch.from_numpy(a) for a in parts)
            if isinstance(packed, tuple) else torch.from_numpy(packed))
    j_in = (tuple(jnp.asarray(a) for a in j_parts)
            if isinstance(j_packed, tuple) else jnp.asarray(j_packed))
    got = tdp.unpack_gid(t_in, fmt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdp.unpack_gid(j_in, j_fmt)))
    np.testing.assert_array_equal(got.numpy(), gid)


@pytest.mark.parametrize("rle", [True, False])
def test_crops_from_packed_ids_equal_the_dense_crops(rle):
    """``gather_crops`` and ``gather_crops_batched`` on the packed group-id
    image give the dense image's crops, bit for bit."""
    rng = np.random.default_rng(3)
    masks = [_line_mask(rng, 128, 512, 5), _line_mask(rng, 128, 512, 8)]
    plans = [tdp.plan_partitions(m, 2, 224) for m in masks]
    for plan in plans:
        coords = tuple(torch.from_numpy(getattr(plan, k))
                       for k in tdp.PartitionPlan.COORD_KEYS)
        packed, fmt = tdp.pack_gid(plan.gid_img, len(plan.partitions),
                                   allow_rle=rle)
        arg = (tuple(torch.from_numpy(a) for a in packed)
               if isinstance(packed, tuple) else torch.from_numpy(packed))
        torch.testing.assert_close(
            tdp.gather_crops(arg, coords, fmt),
            tdp.gather_crops(torch.from_numpy(plan.gid_img), coords),
            rtol=0, atol=0)
    stack = np.stack([p.gid_img for p in plans])
    img_idx = torch.tensor([i for i, p in enumerate(plans)
                            for _ in p.partitions])
    local_id = torch.tensor([j for p in plans
                             for j in range(len(p.partitions))])
    coords = tuple(torch.from_numpy(np.concatenate([getattr(p, k)
                                                    for p in plans]))
                   for k in tdp.PartitionPlan.COORD_KEYS)
    packed, fmt = tdp.pack_gid(stack, max(len(p.partitions) for p in plans),
                               allow_rle=rle)
    arg = (tuple(torch.from_numpy(a) for a in packed)
           if isinstance(packed, tuple) else torch.from_numpy(packed))
    torch.testing.assert_close(
        tdp.gather_crops_batched(arg, img_idx, local_id, coords, fmt),
        tdp.gather_crops_batched(torch.from_numpy(stack), img_idx, local_id,
                                 coords),
        rtol=0, atol=0)

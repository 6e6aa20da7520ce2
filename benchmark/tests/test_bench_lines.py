"""The traffic's line composer and the PNG reader."""

import numpy as np

from harness import lines, png
from harness.cell import ROOT

PARAMS = {"crops_per_line": [1, 6], "height_px": [48, 96],
          "gap_x_height": [0.2, 0.6], "pool_lines": 24, "pool_seed": 5}


def test_png_reader_matches_pillow():
    from PIL import Image
    paths = sorted((ROOT / "examples" / "real_data").glob("*.png"))
    assert paths
    for path in paths:
        want = np.asarray(Image.open(path))
        got = png.read(path)
        assert np.array_equal(got.reshape(want.shape), want), path


def test_crops_read():
    crops = lines.load_crops(ROOT)
    assert len(crops) == 44
    for img, mask, tone in crops:
        assert img.dtype == np.uint8 and img.shape[2] == 3
        assert mask.dtype == bool and mask.shape[0] == 128 and mask.any()
        assert tone.shape == (3,)


def test_pool_is_a_function_of_its_seed():
    crops = lines.load_crops(ROOT)
    a = lines.pool(crops, PARAMS, 128)
    b = lines.pool(crops, PARAMS, 128)
    c = lines.pool(crops, PARAMS | {"pool_seed": 2**31 + 6}, 128)
    assert len(a) == PARAMS["pool_lines"]
    for x, y in zip(a, b):
        assert np.array_equal(x.image, y.image) and np.array_equal(x.mask, y.mask)
    assert any(x.image.shape != z.image.shape or not np.array_equal(x.image, z.image)
               for x, z in zip(a, c))


def test_lines_follow_their_parameters():
    crops = lines.load_crops(ROOT)
    for ln in lines.pool(crops, PARAMS | {"pool_seed": 11}, 128):
        h, w, _ = ln.image.shape
        assert 48 <= h <= 96 and 1 <= len(ln.crops) <= 6
        # The mask lies at the frame the binarizer resizes the line to.
        assert ln.mask.shape == (128, int(w * (128 / h)))
        assert ln.mask.any()

"""The port's host C++ (``native/``: union-find connected components and the
uint8 bilinear resize, built with g++ into ``_build/``) and its connected
components on the device, against the JAX package and the plain versions:
labels, counts, stats and boxes exact against the JAX package's native
path and scipy; the resize bit for bit numpy's; the default backends take
the ctypes call and a failed build raises; ``connected_components_device``
equal to ``connected_components_jnp``."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from stroke_derenderer_tpu.native import cc_native as j_cc
from stroke_derenderer_tpu.ops import connected as jcc
from stroke_derenderer_tpu.ops import resize as jrs
from stroke_derenderer_tpu_torch import native
from stroke_derenderer_tpu_torch.native import cc_native, resize_native
from stroke_derenderer_tpu_torch.ops import connected as tcc
from stroke_derenderer_tpu_torch.ops import resize as trs


def _masks():
    """Random masks of several densities and the probes: empty, one
    diagonal line (one 8-connected island), all foreground, a line wider
    than 3000 px, a single pixel, odd sizes."""
    rng = np.random.default_rng(0)
    out = {f"random {h}x{w} p={p}": rng.random((h, w)) < p
           for h, w, p in ((128, 384, 0.05), (128, 700, 0.3), (64, 97, 0.55),
                           (33, 41, 0.8))}
    diag = np.zeros((128, 400), bool)
    diag[np.arange(128), np.arange(128) + 100] = True
    wide = np.zeros((128, 3100), bool)
    for x0 in rng.integers(0, 3050, 60):
        y0 = rng.integers(0, 110)
        wide[y0:y0 + rng.integers(2, 18), x0:x0 + rng.integers(2, 40)] = True
    one = np.zeros((7, 9), bool)
    one[3, 4] = True
    return out | {"empty": np.zeros((128, 300), bool), "diagonal": diag,
                  "all foreground": np.ones((128, 256), bool),
                  "width 3100": wide, "one pixel": one}


MASKS = _masks()


def _find_objects_boxes(labels, num):
    """The find_objects loop the port's ``bounding_boxes`` replaced."""
    boxes = np.zeros((num, 4), np.int64)
    for i, (ys, xs) in enumerate(ndimage.find_objects(labels, num)):
        boxes[i] = (xs.start, ys.start, xs.stop - xs.start,
                    ys.stop - ys.start)
    return boxes


@pytest.mark.parametrize("name", list(MASKS))
def test_native_cc_matches_jax_native_and_scipy(name):
    m = MASKS[name]
    u8 = m.astype(np.uint8)
    labels, num, stats = cc_native.label_with_stats(u8)
    j_labels, j_num, j_stats = j_cc.label_with_stats(u8)
    np.testing.assert_array_equal(labels, j_labels)
    assert num == j_num
    np.testing.assert_array_equal(stats, j_stats)
    s_labels, s_num = tcc.connected_components(m, backend="scipy")
    np.testing.assert_array_equal(labels, s_labels)
    assert num == s_num
    if name == "diagonal":
        assert num == 1
    # Boxes and areas: native (stats), scipy (vectorized boxes), the JAX
    # package's function and the old find_objects loop all agree.
    got = tcc.connected_components_with_boxes(m, with_area=True)
    plain = tcc.connected_components_with_boxes(m, with_area=True,
                                                backend="scipy")
    want = jcc.connected_components_with_boxes(m, with_area=True)
    for a, b, c in zip(got, plain, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(tcc.bounding_boxes(s_labels, s_num),
                                  _find_objects_boxes(s_labels, s_num))
    np.testing.assert_array_equal(tcc.bounding_boxes(s_labels, s_num),
                                  jcc.bounding_boxes(s_labels, s_num))


@pytest.mark.parametrize("shape", [(128, 1800, 3), (200, 1800, 3),
                                   (77, 301), (50, 123, 3), (224, 60),
                                   (3, 2, 3)])
def test_native_resize_is_numpy_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for dst in ((128, int(shape[1] * 128 / shape[0])), (222, 97), (5, 7),
                (shape[0], shape[1])):
        got = resize_native.resize_u8(img, *dst)
        np.testing.assert_array_equal(
            got, trs.resize_bilinear_np(img, *dst, backend="numpy"))
        np.testing.assert_array_equal(got, jrs.resize_bilinear_np(img, *dst))
    # Floats take numpy, as in the JAX package.
    f = img.astype(np.float32) / 3
    np.testing.assert_array_equal(trs.resize_bilinear_np(f, 9, 11),
                                  jrs.resize_bilinear_np(f, 9, 11))


def test_default_backends_call_the_native_library():
    """With the defaults, uint8 resizes and every connected-components
    entry run the ctypes libraries; ``backend=`` reaches the plain
    versions, which make no native call."""
    m = MASKS["random 128x384 p=0.05"]
    img = np.full((64, 200, 3), 200, np.uint8)
    n_cc, n_rs = cc_native.call_count, resize_native.call_count
    tcc.connected_components(m)
    tcc.connected_components_with_boxes(m)
    trs.resize_to_height_np(img, 128)
    assert (cc_native.call_count, resize_native.call_count) == (
        n_cc + 2, n_rs + 1)
    tcc.connected_components(m, backend="scipy")
    tcc.connected_components_with_boxes(m, backend="scipy")
    trs.resize_to_height_np(img, 128, backend="numpy")
    trs.resize_bilinear_np(img.astype(np.float32), 128, 400)
    assert (cc_native.call_count, resize_native.call_count) == (
        n_cc + 2, n_rs + 1)
    with pytest.raises(ValueError, match="backend"):
        tcc.connected_components(m, backend="cv2")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed.*broken.cpp.*error"):
        native.load("broken")
    assert "broken" not in native._LIBS
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("name", ["random 64x97 p=0.55", "diagonal"])
def test_device_cc_matches_jnp(name):
    """Each jnp call compiles its loops anew: two masks here, every mask
    against the host below."""
    import jax.numpy as jnp
    m = MASKS[name]
    got, num = tcc.connected_components_device(torch.from_numpy(m))
    want, j_num = jcc.connected_components_jnp(jnp.asarray(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert num == int(j_num)


@pytest.mark.parametrize("name", [n for n in MASKS if n not in (
    "random 128x700 p=0.3", "width 3100")])  # many rounds on the CPU
def test_device_cc_matches_the_host(name):
    m = MASKS[name]
    got, num = tcc.connected_components_device(torch.from_numpy(m))
    labels, n = tcc.connected_components(m)
    np.testing.assert_array_equal(got.numpy(), labels)
    assert num == n


def test_device_cc_on_a_spiral():
    """A spiral's labels run a long way round: many rounds of the min
    propagation, the same labels as the host."""
    m = np.zeros((41, 41), bool)
    y, x, dy, dx, k = 20, 20, 0, 1, 1
    while 0 <= y < 41 and 0 <= x < 41:
        for _ in range(2):
            for _ in range(k):
                if 0 <= y < 41 and 0 <= x < 41:
                    m[y, x] = True
                y, x = y + dy, x + dx
            dy, dx = dx, -dy
        k += 2
    m[0, 0] = m[40, 3] = True
    got, num = tcc.connected_components_device(torch.from_numpy(m))
    labels, n = tcc.connected_components(m)
    np.testing.assert_array_equal(got.numpy(), labels)
    assert num == n

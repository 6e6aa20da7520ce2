// Separable bilinear resize, OpenCV half-pixel-center semantics, uint8: a
// copy of the JAX package's native/resize.cpp.
//
// Bit-identical twin of ops/resize.py:resize_bilinear_np(backend="numpy"):
// identical interpolation coordinates (double precision, the same
// clamp-to-edge rules as cv2 / _interp_coords), identical float32 lerp
// order (full-width vertical pass first, then horizontal gather, each as
// a + f*(b-a) rounded to float32 per step; built with -ffp-contract=off
// so no FMA changes the rounding), identical uint8 quantization
// (rint = round-half-to-even, then clamp). The reference resizes with
// cv2.resize INTER_LINEAR everywhere (common.py:85-93, split.py:127-135,
// partition.py:101-140). ctypes calls release the GIL, so this resize
// overlaps the other stage's Python work in the two-stage pipeline.
//
// Exported C ABI:
//   sd_resize_u8(src, src_h, src_w, channels, dst, dst_h, dst_w)
//     src: (src_h, src_w, channels) uint8, C-contiguous
//     dst: (dst_h, dst_w, channels) uint8, preallocated
//   returns 0 on success, <0 on bad arguments.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Coords {
  std::vector<int32_t> i0, i1;
  std::vector<float> f;
};

// Mirror of ops/resize.py:_interp_coords (double math, then float32 f).
Coords interp_coords(int src, int dst) {
  Coords c;
  c.i0.resize(dst);
  c.i1.resize(dst);
  c.f.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int i = 0; i < dst; ++i) {
    double x = (i + 0.5) * scale - 0.5;
    double x0 = std::floor(x);
    double f = x - x0;
    int64_t i0 = static_cast<int64_t>(x0);
    if (i0 < 0) f = 0.0;
    if (i0 < 0) i0 = 0;
    if (i0 > src - 1) i0 = src - 1;
    if (i0 >= src - 1) f = 0.0;
    int64_t i1 = i0 + 1;
    if (i1 > src - 1) i1 = src - 1;
    c.i0[i] = static_cast<int32_t>(i0);
    c.i1[i] = static_cast<int32_t>(i1);
    c.f[i] = static_cast<float>(f);
  }
  return c;
}

}  // namespace

extern "C" int sd_resize_u8(const uint8_t* src, int32_t src_h, int32_t src_w,
                            int32_t channels, uint8_t* dst, int32_t dst_h,
                            int32_t dst_w) {
  if (!src || !dst || src_h <= 0 || src_w <= 0 || channels <= 0 ||
      dst_h <= 0 || dst_w <= 0)
    return -1;
  const Coords cy = interp_coords(src_h, dst_h);
  const Coords cx = interp_coords(src_w, dst_w);
  const int64_t row = static_cast<int64_t>(src_w) * channels;

  // One vertically-interpolated source-width row at a time (float32),
  // then the horizontal gather+lerp into the output row. This is the
  // exact op order of resize_bilinear_np: the vertical result is rounded
  // to float32 BEFORE the horizontal lerp reads it.
  std::vector<float> vrow(row);
  for (int i = 0; i < dst_h; ++i) {
    const uint8_t* a = src + static_cast<int64_t>(cy.i0[i]) * row;
    const uint8_t* b = src + static_cast<int64_t>(cy.i1[i]) * row;
    const float fy = cy.f[i];
    for (int64_t k = 0; k < row; ++k) {
      const float av = static_cast<float>(a[k]);
      const float d = static_cast<float>(b[k]) - av;  // float32 subtract
      const float m = d * fy;                         // float32 multiply
      vrow[k] = av + m;                               // float32 add
    }
    uint8_t* out = dst + static_cast<int64_t>(i) * dst_w * channels;
    for (int j = 0; j < dst_w; ++j) {
      const float* l = vrow.data() + static_cast<int64_t>(cx.i0[j]) * channels;
      const float* r = vrow.data() + static_cast<int64_t>(cx.i1[j]) * channels;
      const float fx = cx.f[j];
      for (int ch = 0; ch < channels; ++ch) {
        const float lv = l[ch];
        const float d = r[ch] - lv;
        const float m = d * fx;
        float v = lv + m;
        v = std::rint(v);  // numpy rint: round-half-to-even
        if (v < 0.0f) v = 0.0f;
        if (v > 255.0f) v = 255.0f;
        out[static_cast<int64_t>(j) * channels + ch] =
            static_cast<uint8_t>(v);
      }
    }
  }
  return 0;
}

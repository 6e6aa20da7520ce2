// Host connected components (8-connectivity) with stats: a copy of the JAX
// package's native/cc.cpp, the port's counterpart of the reference's
// cv2.connectedComponentsWithStats (reference partition.py:14). Glyph
// segmentation of the 128xW binarized line mask is a small host step
// between the binarizer and the encoder, and this union-find runs it
// without the GIL (a ctypes call releases it).
//
// Two-pass scanning union-find with path compression:
//   pass 1: raster scan, union with W/NW/N/NE neighbors;
//   pass 2: resolve roots, assign compact labels in raster first-encounter
//           order (background = 0), accumulate per-label stats.
//
// C ABI (ctypes-friendly), no dependencies. Built with g++ -O3 -shared
// -fPIC by native/__init__.py.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct UF {
  std::vector<int32_t> parent;
  explicit UF(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

}  // namespace

extern "C" {

// img: h*w uint8 (nonzero = foreground), row-major.
// labels_out: h*w int32, 0 = background, 1..num in raster order.
// stats_out: max_components * 5 int32 rows [left, top, width, height, area]
//            for labels 1..num (row 0 <-> label 1).
// Returns the number of components, or -1 if it exceeds max_components.
int32_t sd_cc_label(const uint8_t* img, int32_t h, int32_t w,
                    int32_t* labels_out, int32_t* stats_out,
                    int32_t max_components) {
  const int64_t n = static_cast<int64_t>(h) * w;
  UF uf(static_cast<size_t>(n));

  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = img + static_cast<int64_t>(y) * w;
    const uint8_t* up = y > 0 ? img + static_cast<int64_t>(y - 1) * w : nullptr;
    for (int32_t x = 0; x < w; ++x) {
      if (!row[x]) continue;
      const int32_t p = y * w + x;
      if (x > 0 && row[x - 1]) uf.unite(p, p - 1);
      if (up) {
        if (up[x]) uf.unite(p, p - w);
        if (x > 0 && up[x - 1]) uf.unite(p, p - w - 1);
        if (x + 1 < w && up[x + 1]) uf.unite(p, p - w + 1);
      }
    }
  }

  // Compact labels in raster first-encounter order of each root.
  std::vector<int32_t> root_label(static_cast<size_t>(n), 0);
  int32_t num = 0;
  for (int64_t p = 0; p < n; ++p) {
    if (!img[p]) {
      labels_out[p] = 0;
      continue;
    }
    const int32_t r = uf.find(static_cast<int32_t>(p));
    if (root_label[r] == 0) {
      if (num >= max_components) return -1;
      root_label[r] = ++num;
      const int32_t y = static_cast<int32_t>(p / w);
      const int32_t x = static_cast<int32_t>(p % w);
      int32_t* s = stats_out + static_cast<int64_t>(num - 1) * 5;
      s[0] = x;  // left
      s[1] = y;  // top
      s[2] = x;  // right (max x, fixed up below)
      s[3] = y;  // bottom (max y)
      s[4] = 0;  // area
    }
    const int32_t lbl = root_label[r];
    labels_out[p] = lbl;
    const int32_t y = static_cast<int32_t>(p / w);
    const int32_t x = static_cast<int32_t>(p % w);
    int32_t* s = stats_out + static_cast<int64_t>(lbl - 1) * 5;
    if (x < s[0]) s[0] = x;
    if (y < s[1]) s[1] = y;
    if (x > s[2]) s[2] = x;
    if (y > s[3]) s[3] = y;
    s[4] += 1;
  }

  // Convert right/bottom to width/height.
  for (int32_t i = 0; i < num; ++i) {
    int32_t* s = stats_out + static_cast<int64_t>(i) * 5;
    s[2] = s[2] - s[0] + 1;
    s[3] = s[3] - s[1] + 1;
  }
  return num;
}

}  // extern "C"

// Host-side click distance maps: the port's copy of
// pvpuformer_tpu/native/dist_maps.cc (the same C ABI and output; the
// distance in double, as the Python BFS computes it).
//
// C++ re-implementation of the reference's only compiled component, the
// Cython/C++ BFS flood fill (`isegm/utils/cython/_get_dist_maps.pyx:17-63`,
// built with language='c++' -O3): from each click seed, a 4-neighborhood BFS
// relaxes per-layer (positive/negative) normalized squared distances, with
// each frontier pixel inheriting its parent's origin click. A library
// function for host-only callers; the model's disk maps are the closed
// form of ops/distmaps.py on the device.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct QNode {
  int32_t row, col, layer, orig_row, orig_col;
};

}  // namespace

extern "C" {

// points: (n_points, >=2) row-major float32 of (row, col); rows with
// row < 0 are padding. The first half of the rows are positive clicks
// (layer 0), the rest negative (layer 1) — matching the (2N, 3) click
// tensor convention. out: (2, height, width) float32, pre-allocated.
void get_dist_maps(const float* points, int n_points, int point_stride,
                   int height, int width, float norm_delimiter, float* out) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int64_t i = 0; i < 2 * plane; ++i) out[i] = 1e6f;

  std::vector<QNode> queue;
  queue.reserve(static_cast<size_t>(4) * plane + 1);

  for (int i = 0; i < n_points; ++i) {
    const float* p = points + static_cast<int64_t>(i) * point_stride;
    int x = static_cast<int>(std::lround(p[0]));
    int y = static_cast<int>(std::lround(p[1]));
    if (x < 0 || y < 0 || x >= height || y >= width) continue;
    int layer = (i >= n_points / 2) ? 1 : 0;
    queue.push_back({x, y, layer, x, y});
    out[layer * plane + static_cast<int64_t>(x) * width + y] = 0.0f;
  }

  static const int dxy[8] = {-1, 0, 0, -1, 0, 1, 1, 0};
  for (size_t head = 0; head < queue.size(); ++head) {
    const QNode v = queue[head];
    for (int k = 0; k < 4; ++k) {
      int x = v.row + dxy[2 * k];
      int y = v.col + dxy[2 * k + 1];
      if (x < 0 || y < 0 || x >= height || y >= width) continue;
      // in double, rounded to float once: the Python BFS's arithmetic
      // (get_dist_maps_numpy), so the two agree bit for bit at every
      // delimiter that float holds; built with -ffp-contract=off, so no
      // FMA rounds otherwise
      const double dx = (x - v.orig_row) / static_cast<double>(norm_delimiter);
      const double dy = (y - v.orig_col) / static_cast<double>(norm_delimiter);
      const float ndist = static_cast<float>(dx * dx + dy * dy);
      float* cell = out + v.layer * plane +
                    static_cast<int64_t>(x) * width + y;
      if (*cell > ndist) {
        *cell = ndist;
        queue.push_back({x, y, v.layer, v.orig_row, v.orig_col});
      }
    }
  }
}

}  // extern "C"

// k-nearest-neighbor mean distances for splat scale initialization.
//
// Native equivalent of the reference's kiddo KD-tree usage
// (reference: gaussian_splats.rs:108-120): for every point, the sqrt of the
// sum of the k smallest squared distances (the query point itself included,
// as kiddo returns exact matches) divided by k.
//
// A median-split KD-tree over index arrays; queries keep a small insertion-
// sorted best-list (k <= 16). O(n log n) build, ~O(log n) per query.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct KdTree {
  const float* pts;  // (n, 3)
  std::vector<int64_t> idx;
  std::vector<int> axis;  // split axis per internal node (aligned with idx)

  explicit KdTree(const float* p, int64_t n) : pts(p), idx(n), axis(n, -1) {
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    build(0, n);
  }

  void build(int64_t lo, int64_t hi) {
    if (hi - lo <= 1) return;
    // Pick the widest axis of the bounding box of this span.
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = lo; i < hi; ++i) {
      const float* p = pts + idx[i] * 3;
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], p[a]);
        mx[a] = std::max(mx[a], p[a]);
      }
    }
    int ax = 0;
    float w = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a)
      if (mx[a] - mn[a] > w) { w = mx[a] - mn[a]; ax = a; }
    int64_t mid = (lo + hi) / 2;
    std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                     [&](int64_t a, int64_t b) {
                       return pts[a * 3 + ax] < pts[b * 3 + ax];
                     });
    axis[mid] = ax;
    build(lo, mid);
    build(mid + 1, hi);
  }

  // Insertion-sorted best-k squared distances.
  void query(const float* q, int k, float* best, int64_t lo, int64_t hi) const {
    if (hi <= lo) return;
    int64_t mid = (lo + hi) / 2;
    const float* p = pts + idx[mid] * 3;
    float d2 = 0;
    for (int a = 0; a < 3; ++a) {
      float d = p[a] - q[a];
      d2 += d * d;
    }
    if (d2 < best[k - 1]) {
      int j = k - 1;
      while (j > 0 && best[j - 1] > d2) {
        best[j] = best[j - 1];
        --j;
      }
      best[j] = d2;
    }
    if (hi - lo == 1) return;
    int ax = axis[mid];
    float delta = q[ax] - p[ax];
    if (delta < 0) {
      query(q, k, best, lo, mid);
      if (delta * delta < best[k - 1]) query(q, k, best, mid + 1, hi);
    } else {
      query(q, k, best, mid + 1, hi);
      if (delta * delta < best[k - 1]) query(q, k, best, lo, mid);
    }
  }
};

}  // namespace

extern "C" {

// out[i] = sqrt(sum of k smallest squared distances from pts[i]) / k.
void knn_mean_distance(const float* pts, int64_t n, int k, float* out) {
  if (n == 0) return;
  if (k > 16) k = 16;
  KdTree tree(pts, n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float best[16];
    for (int j = 0; j < k; ++j) best[j] = 1e30f;
    tree.query(pts + i * 3, k, best, 0, n);
    float sum = 0;
    for (int j = 0; j < k; ++j) sum += (best[j] < 1e29f ? best[j] : 0.0f);
    out[i] = std::sqrt(sum) / static_cast<float>(k);
  }
}

}  // extern "C"

// Native host-side ops of the port's data pipeline: per-image proposal
// cleaning (dedup by the rounded coordinate hash, clip, min-size), which
// runs in the data loader's threads for every image, greedy NMS and the
// +1-convention IoU matrix. A C interface loaded with ctypes by
// odwscl_tpu_torch/utils/host_ops.py, which builds it at first use
// (g++ -O3 -shared -fPIC -ffp-contract=off) into the checkout's build/
// directory; the same arithmetic as odwscl_tpu/csrc/host_ops.cpp. The
// numpy versions in that module and in data/proposals.py are the plain
// versions it is held to.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

// Greedy NMS, torchvision conventions (no +1 area, suppress IoU > thresh).
// boxes: [n,4] xyxy float32; scores: [n]; keep_out: [n] int32 buffer.
// Returns number of kept indices (written to keep_out in descending-score
// order), as host_ops.py's nms_plain.
int32_t host_nms(const float* boxes, const float* scores, int32_t n,
                 float iou_thresh, int32_t* keep_out) {
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return scores[a] > scores[b]; });
  std::vector<char> suppressed(n, 0);
  std::vector<float> areas(n);
  for (int32_t i = 0; i < n; ++i) {
    areas[i] = (boxes[i * 4 + 2] - boxes[i * 4]) *
               (boxes[i * 4 + 3] - boxes[i * 4 + 1]);
  }
  int32_t n_keep = 0;
  for (int32_t oi = 0; oi < n; ++oi) {
    int32_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float ix1 = boxes[i * 4], iy1 = boxes[i * 4 + 1];
    const float ix2 = boxes[i * 4 + 2], iy2 = boxes[i * 4 + 3];
    for (int32_t oj = oi + 1; oj < n; ++oj) {
      int32_t j = order[oj];
      if (suppressed[j]) continue;
      const float xx1 = std::max(ix1, boxes[j * 4]);
      const float yy1 = std::max(iy1, boxes[j * 4 + 1]);
      const float xx2 = std::min(ix2, boxes[j * 4 + 2]);
      const float yy2 = std::min(iy2, boxes[j * 4 + 3]);
      const float w = std::max(0.f, xx2 - xx1);
      const float h = std::max(0.f, yy2 - yy1);
      const float inter = w * h;
      const float uni = areas[i] + areas[j] - inter;
      if (uni > 0.f && inter / uni > iou_thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// Pairwise IoU with the Detectron +1 convention (boxlist_ops.py:127-160).
// a: [n,4], b: [m,4], out: [n*m] float32 row-major.
void host_iou_plus1(const float* a, int32_t n, const float* b, int32_t m,
                    float* out) {
  std::vector<float> area_b(m);
  for (int32_t j = 0; j < m; ++j) {
    area_b[j] = (b[j * 4 + 2] - b[j * 4] + 1.f) *
                (b[j * 4 + 3] - b[j * 4 + 1] + 1.f);
  }
  for (int32_t i = 0; i < n; ++i) {
    const float ax1 = a[i * 4], ay1 = a[i * 4 + 1];
    const float ax2 = a[i * 4 + 2], ay2 = a[i * 4 + 3];
    const float area_a = (ax2 - ax1 + 1.f) * (ay2 - ay1 + 1.f);
    for (int32_t j = 0; j < m; ++j) {
      const float xx1 = std::max(ax1, b[j * 4]);
      const float yy1 = std::max(ay1, b[j * 4 + 1]);
      const float xx2 = std::min(ax2, b[j * 4 + 2]);
      const float yy2 = std::min(ay2, b[j * 4 + 3]);
      const float w = std::max(0.f, xx2 - xx1 + 1.f);
      const float h = std::max(0.f, yy2 - yy1 + 1.f);
      const float inter = w * h;
      out[i * m + j] = inter / (area_a + area_b[j] - inter);
    }
  }
}

// Proposal cleaning in one pass (reference coco.py:52 unique_boxes +
// voc.py:105-111 clip + remove_small_boxes): dedup by the rounded
// coordinate hash [1, 1e3, 1e6, 1e9], clip to (w-1, h-1), drop empty and
// boxes with xywh side < min_size. boxes: [n,4] float64 in, out: [n,4]
// float32; returns kept count. Keeps first occurrence, original order.
int32_t host_clean_proposals(const double* boxes, int32_t n, float img_w,
                             float img_h, float min_size, float* out) {
  std::unordered_set<int64_t> seen;
  seen.reserve(n * 2);
  int32_t n_out = 0;
  for (int32_t i = 0; i < n; ++i) {
    const double hash = std::round(boxes[i * 4]) +
                        std::round(boxes[i * 4 + 1]) * 1e3 +
                        std::round(boxes[i * 4 + 2]) * 1e6 +
                        std::round(boxes[i * 4 + 3]) * 1e9;
    const int64_t key = (int64_t)hash;
    if (!seen.insert(key).second) continue;
    float x1 = (float)boxes[i * 4], y1 = (float)boxes[i * 4 + 1];
    float x2 = (float)boxes[i * 4 + 2], y2 = (float)boxes[i * 4 + 3];
    x1 = std::min(std::max(x1, 0.f), img_w - 1.f);
    x2 = std::min(std::max(x2, 0.f), img_w - 1.f);
    y1 = std::min(std::max(y1, 0.f), img_h - 1.f);
    y2 = std::min(std::max(y2, 0.f), img_h - 1.f);
    if (!(x2 > x1 && y2 > y1)) continue;
    if (min_size > 0.f &&
        ((x2 - x1 + 1.f) < min_size || (y2 - y1 + 1.f) < min_size))
      continue;
    out[n_out * 4] = x1;
    out[n_out * 4 + 1] = y1;
    out[n_out * 4 + 2] = x2;
    out[n_out * 4 + 3] = y2;
    ++n_out;
  }
  return n_out;
}

}  // extern "C"

// Host NMS of the port's native library (its own copy of the JAX
// package's native/nms.cpp): greedy hard NMS and Soft-NMS with the legacy
// +1 IoU, as the reference's cpu_nms.pyx, nms_cpu.cpp and
// soft_nms_cpu.pyx compute them, for host tools whose detections are
// already numpy arrays. The card's NMS is vps_torch/ops/nms.py.
//
// C interface (ctypes, vps_torch/native/__init__.py):
//   int cpu_nms(const float* dets, int n, float thresh, int* keep);
//       dets rows: (x1, y1, x2, y2, score), in any order (sorted here by
//       descending score, stable). Returns the number kept; their indices
//       land in keep[0..ret).
//   int cpu_soft_nms(float* dets, int n, float iou_thr, float sigma,
//                    float min_score, int method, int* keep);
//       method: 0 = hard, 1 = linear, 2 = gaussian. Rescores the score
//       column in place; returns the number kept, in the order taken.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {
inline float iou_p1(const float* a, const float* b) {
    float iw = std::min(a[2], b[2]) - std::max(a[0], b[0]) + 1.0f;
    if (iw <= 0) return 0.0f;
    float ih = std::min(a[3], b[3]) - std::max(a[1], b[1]) + 1.0f;
    if (ih <= 0) return 0.0f;
    float sa = (a[2] - a[0] + 1.0f) * (a[3] - a[1] + 1.0f);
    float sb = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
    return iw * ih / (sa + sb - iw * ih);
}
}  // namespace

extern "C" {

int cpu_nms(const float* dets, int n, float thresh, int* keep) {
    std::vector<int> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int i, int j) {
        return dets[i * 5 + 4] > dets[j * 5 + 4];
    });
    std::vector<char> suppressed(n, 0);
    int nkeep = 0;
    for (int oi = 0; oi < n; oi++) {
        int i = order[oi];
        if (suppressed[i]) continue;
        keep[nkeep++] = i;
        for (int oj = oi + 1; oj < n; oj++) {
            int j = order[oj];
            if (suppressed[j]) continue;
            if (iou_p1(dets + i * 5, dets + j * 5) > thresh) suppressed[j] = 1;
        }
    }
    return nkeep;
}

int cpu_soft_nms(float* dets, int n, float iou_thr, float sigma,
                 float min_score, int method, int* keep) {
    // Greedy: repeatedly take the max-score box, decay overlaps.
    std::vector<char> done(n, 0);
    int nkeep = 0;
    for (int it = 0; it < n; it++) {
        int best = -1;
        float best_s = min_score;
        for (int i = 0; i < n; i++) {
            if (!done[i] && dets[i * 5 + 4] > best_s) {
                best_s = dets[i * 5 + 4];
                best = i;
            }
        }
        if (best < 0) break;
        done[best] = 1;
        keep[nkeep++] = best;
        for (int j = 0; j < n; j++) {
            if (done[j]) continue;
            float ov = iou_p1(dets + best * 5, dets + j * 5);
            float w = 1.0f;
            if (method == 1) {  // linear
                if (ov > iou_thr) w = 1.0f - ov;
            } else if (method == 2) {  // gaussian
                w = std::exp(-(ov * ov) / sigma);
            } else {  // hard
                if (ov > iou_thr) w = 0.0f;
            }
            dets[j * 5 + 4] *= w;
        }
    }
    return nkeep;
}

}  // extern "C"

// socio_host — native host-side data/runtime kernels (C ABI, loaded via ctypes).
//
// Plays the role the reference delegates to OpenCV + scipy + PIL on its host
// hot paths (SURVEY.md §2.10 item 8, §7 hard part (e)):
//   resize (bilinear/nearest)            — cv2.resize / PIL resize
//   patchify_normalize                    — Qwen2VL image → patch rows
//   connected_components / component_boxes — cv2.connectedComponents / findContours
//   hungarian                             — scipy.optimize.linear_sum_assignment
//   mask_iou                              — reward pixel IoU
//   render_overlay                        — PIL bbox draw + alpha composite
//
// Build: socioreasoner_tpu_torch/utils/native.py runs g++ at first use into
// socioreasoner_tpu_torch/_build/libsocio_host.so (plain g++, no deps).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// --------------------------------------------------------------------- resize

// Bilinear uint8 resize, half-pixel centers (align_corners=False).
void resize_bilinear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                        uint8_t* dst, int64_t oh, int64_t ow) {
  const double sy = (double)h / oh;
  const double sx = (double)w / ow;
  for (int64_t y = 0; y < oh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int64_t y0 = (int64_t)std::floor(fy);
    double wy = fy - y0;
    int64_t y1 = std::min(std::max(y0 + 1, (int64_t)0), h - 1);
    y0 = std::min(std::max(y0, (int64_t)0), h - 1);
    for (int64_t x = 0; x < ow; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int64_t x0 = (int64_t)std::floor(fx);
      double wx = fx - x0;
      int64_t x1 = std::min(std::max(x0 + 1, (int64_t)0), w - 1);
      x0 = std::min(std::max(x0, (int64_t)0), w - 1);
      for (int64_t ch = 0; ch < c; ++ch) {
        double v00 = src[(y0 * w + x0) * c + ch];
        double v01 = src[(y0 * w + x1) * c + ch];
        double v10 = src[(y1 * w + x0) * c + ch];
        double v11 = src[(y1 * w + x1) * c + ch];
        double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                   v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * ow + x) * c + ch] = (uint8_t)std::lround(std::min(std::max(v, 0.0), 255.0));
      }
    }
  }
}

// Nearest uint8 resize (floor mapping, matches cv2.INTER_NEAREST / PIL NEAREST).
void resize_nearest_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                       uint8_t* dst, int64_t oh, int64_t ow) {
  const double sy = (double)h / oh;
  const double sx = (double)w / ow;
  for (int64_t y = 0; y < oh; ++y) {
    int64_t yy = std::min((int64_t)(y * sy), h - 1);
    for (int64_t x = 0; x < ow; ++x) {
      int64_t xx = std::min((int64_t)(x * sx), w - 1);
      std::memcpy(dst + (y * ow + x) * c, src + (yy * w + xx) * c, c);
    }
  }
}

// ---------------------------------------------------------------- patchify

// uint8 HWC (already smart-resized) → float32 Qwen patch rows:
// rescale 1/255, normalize (mean/std per channel), layout
// (grid_h/ms, grid_w/ms, ms, ms, C, tps, ps, ps) flattened rows of
// C*tps*ps*ps — exactly Qwen2VLImageProcessor._preprocess's transpose.
void patchify_normalize(const uint8_t* src, int64_t h, int64_t w,
                        const float* mean, const float* stdv,
                        int64_t ps, int64_t ms, int64_t tps, float* dst) {
  const int64_t gh = h / ps, gw = w / ps;
  const int64_t row_len = 3 * tps * ps * ps;
  for (int64_t bh = 0; bh < gh / ms; ++bh)
    for (int64_t bw = 0; bw < gw / ms; ++bw)
      for (int64_t mh = 0; mh < ms; ++mh)
        for (int64_t mw = 0; mw < ms; ++mw) {
          int64_t patch_idx = ((bh * (gw / ms) + bw) * ms + mh) * ms + mw;
          float* out = dst + patch_idx * row_len;
          int64_t py = (bh * ms + mh) * ps;
          int64_t px = (bw * ms + mw) * ps;
          for (int64_t ch = 0; ch < 3; ++ch) {
            float m = mean[ch], s = stdv[ch];
            for (int64_t t = 0; t < tps; ++t)
              for (int64_t dy = 0; dy < ps; ++dy)
                for (int64_t dx = 0; dx < ps; ++dx) {
                  uint8_t raw = src[((py + dy) * w + (px + dx)) * 3 + ch];
                  out[((ch * tps + t) * ps + dy) * ps + dx] =
                      (raw / 255.0f - m) / s;
                }
          }
        }
}

// --------------------------------------------------- connected components

static int64_t find_root(std::vector<int64_t>& parent, int64_t i) {
  while (parent[i] != i) {
    parent[i] = parent[parent[i]];
    i = parent[i];
  }
  return i;
}

// 8-connected components of mask>0. Returns count; labels (optional, may be
// null) receives 1-based component ids.
int64_t connected_components(const uint8_t* mask, int64_t h, int64_t w,
                             int32_t* labels_out) {
  std::vector<int64_t> parent(1, 0);
  std::vector<int64_t> row_labels(w, 0), prev_labels(w, 0);
  std::vector<int32_t> all_labels;
  if (labels_out) all_labels.resize(h * w, 0);

  auto make_set = [&]() {
    parent.push_back((int64_t)parent.size());
    return (int64_t)parent.size() - 1;
  };
  auto unite = [&](int64_t a, int64_t b) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  };

  for (int64_t y = 0; y < h; ++y) {
    std::swap(prev_labels, row_labels);
    std::fill(row_labels.begin(), row_labels.end(), 0);
    for (int64_t x = 0; x < w; ++x) {
      if (!mask[y * w + x]) continue;
      int64_t label = 0;
      // neighbors: left, up-left, up, up-right
      int64_t neigh[4] = {
          x > 0 ? row_labels[x - 1] : 0,
          (y > 0 && x > 0) ? prev_labels[x - 1] : 0,
          y > 0 ? prev_labels[x] : 0,
          (y > 0 && x + 1 < w) ? prev_labels[x + 1] : 0};
      for (int i = 0; i < 4; ++i)
        if (neigh[i]) label = label ? std::min(label, neigh[i]) : neigh[i];
      if (!label) label = make_set();
      for (int i = 0; i < 4; ++i)
        if (neigh[i]) unite(label, neigh[i]);
      row_labels[x] = label;
      if (labels_out) all_labels[y * w + x] = (int32_t)label;
    }
  }
  // count roots + compact labels
  std::vector<int64_t> remap(parent.size(), 0);
  int64_t count = 0;
  for (int64_t i = 1; i < (int64_t)parent.size(); ++i)
    if (find_root(parent, i) == i) remap[i] = ++count;
  if (labels_out) {
    for (int64_t i = 0; i < h * w; ++i) {
      int32_t l = all_labels[i];
      labels_out[i] = l ? (int32_t)remap[find_root(parent, l)] : 0;
    }
  }
  return count;
}

// Bounding boxes + pixel areas of components. boxes_out: (max_boxes, 5) rows
// [x1, y1, x2, y2, area] (x2/y2 exclusive). Returns number written.
int64_t component_boxes(const uint8_t* mask, int64_t h, int64_t w,
                        int64_t min_area, int64_t* boxes_out,
                        int64_t max_boxes) {
  std::vector<int32_t> labels(h * w);
  int64_t count = connected_components(mask, h, w, labels.data());
  if (count == 0) return 0;
  std::vector<int64_t> x1(count + 1, std::numeric_limits<int64_t>::max());
  std::vector<int64_t> y1(count + 1, std::numeric_limits<int64_t>::max());
  std::vector<int64_t> x2(count + 1, -1), y2(count + 1, -1), area(count + 1, 0);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      int32_t l = labels[y * w + x];
      if (!l) continue;
      x1[l] = std::min(x1[l], x);
      y1[l] = std::min(y1[l], y);
      x2[l] = std::max(x2[l], x);
      y2[l] = std::max(y2[l], y);
      area[l]++;
    }
  int64_t n = 0;
  for (int64_t l = 1; l <= count && n < max_boxes; ++l) {
    if (area[l] <= min_area) continue;
    boxes_out[n * 5 + 0] = x1[l];
    boxes_out[n * 5 + 1] = y1[l];
    boxes_out[n * 5 + 2] = x2[l] + 1;
    boxes_out[n * 5 + 3] = y2[l] + 1;
    boxes_out[n * 5 + 4] = area[l];
    n++;
  }
  return n;
}

// ------------------------------------------------------------- hungarian

// Jonker-Volgenant style O(n^3) assignment on an n×m cost matrix (n<=m).
// row_to_col out: (n,). Minimizes total cost. (scipy linear_sum_assignment
// equivalent for n<=m; caller transposes otherwise.)
void hungarian(const double* cost, int64_t n, int64_t m, int64_t* row_to_col) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int64_t> p(m + 1, 0), way(m + 1, 0);
  for (int64_t i = 1; i <= n; ++i) {
    p[0] = i;
    int64_t j0 = 0;
    std::vector<double> minv(m + 1, INF);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int64_t i0 = p[j0], j1 = 0;
      double delta = INF;
      for (int64_t j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int64_t j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int64_t j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int64_t j = 1; j <= m; ++j)
    if (p[j]) row_to_col[p[j] - 1] = j - 1;
}

// --------------------------------------------------------------- mask iou

double mask_iou(const uint8_t* a, const uint8_t* b, int64_t n) {
  int64_t inter = 0, uni = 0;
  for (int64_t i = 0; i < n; ++i) {
    bool pa = a[i] != 0, pb = b[i] != 0;
    inter += pa && pb;
    uni += pa || pb;
  }
  if (uni == 0) return -1.0;  // caller applies the empty-empty convention
  return (double)inter / (double)uni;
}

// ------------------------------------------------------------- rendering

// In-place: draw `nb` rectangle outlines (boxes: x1,y1,x2,y2 rows; rgb color,
// width px) then alpha-blend `mask>0` pixels with overlay color.
void render_overlay(uint8_t* img, int64_t h, int64_t w, const int64_t* boxes,
                    int64_t nb, uint8_t br, uint8_t bg, uint8_t bb,
                    int64_t bwidth, const uint8_t* mask, int64_t mh, int64_t mw,
                    uint8_t mr, uint8_t mg, uint8_t mb, double alpha) {
  auto put = [&](int64_t y, int64_t x) {
    if (y < 0 || y >= h || x < 0 || x >= w) return;
    uint8_t* p = img + (y * w + x) * 3;
    p[0] = br; p[1] = bg; p[2] = bb;
  };
  for (int64_t b = 0; b < nb; ++b) {
    int64_t x1 = boxes[b * 4], y1 = boxes[b * 4 + 1];
    int64_t x2 = boxes[b * 4 + 2], y2 = boxes[b * 4 + 3];
    for (int64_t t = 0; t < bwidth; ++t) {
      for (int64_t x = x1; x <= x2; ++x) { put(y1 + t, x); put(y2 - t, x); }
      for (int64_t y = y1; y <= y2; ++y) { put(y, x1 + t); put(y, x2 - t); }
    }
  }
  if (mask) {
    for (int64_t y = 0; y < h; ++y) {
      int64_t my = mh == h ? y : (int64_t)((double)y * mh / h);
      for (int64_t x = 0; x < w; ++x) {
        int64_t mx = mw == w ? x : (int64_t)((double)x * mw / w);
        if (mask[my * mw + mx]) {
          uint8_t* p = img + (y * w + x) * 3;
          p[0] = (uint8_t)std::lround(p[0] * (1 - alpha) + mr * alpha);
          p[1] = (uint8_t)std::lround(p[1] * (1 - alpha) + mg * alpha);
          p[2] = (uint8_t)std::lround(p[2] * (1 - alpha) + mb * alpha);
        }
      }
    }
  }
}

}  // extern "C"

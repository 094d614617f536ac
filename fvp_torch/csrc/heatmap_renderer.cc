// Native gaussian heatmap renderer — the host-side hot loop of the data
// pipeline (rendering per-view joint gaussians for the 'gt'/'pred' heatmap
// sources). Mirrors fvp_tpu/data/heatmaps.py::generate_input_heatmap
// (behavioral reference: the original lib/dataset/JointsDataset.py:368-446)
// including the augmentation branch (random per-joint peak scaling with
// wrist/ankle-specific drop rates + a random rectangular occlusion applied
// in window-local indices drawn from heatmap-global ranges — the
// reference's quirk at JointsDataset.py:414-431, preserved). Augmentation
// draws from a seeded xorshift stream: same DISTRIBUTION as the numpy
// path, not the same sample stream, and deterministic for a given seed.
//
// Built as a plain C-ABI shared library, loaded via ctypes
// (fvp_tpu/data/native.py). OpenMP parallel over people x joints would race
// on the max-combine, so parallelism is over output joints.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Rng {
  // xorshift64* — plenty for augmentation jitter
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
  double uniform(double lo, double hi) { return lo + uniform() * (hi - lo); }
  double gauss() {  // Box-Muller
    double u1 = uniform(), u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    return std::sqrt(-2.0 * std::log(u1)) *
           std::cos(2.0 * 3.14159265358979323846 * u2);
  }
};

float human_scale(const float* pose, int n_joints, float sx, float sy) {
  // compute_human_scale on stride-normalized coords, all joints visible
  float minx = 1e30f, maxx = -1e30f, miny = 1e30f, maxy = -1e30f;
  for (int j = 0; j < n_joints; ++j) {
    float x = pose[2 * j] / sx;
    float y = pose[2 * j + 1] / sy;
    minx = std::min(minx, x);
    maxx = std::max(maxx, x);
    miny = std::min(miny, y);
    maxy = std::max(maxy, y);
  }
  float ext = std::max(maxy - miny, maxx - minx);
  float sq = ext * ext;
  float lo = 96.0f * 96.0f / 4.0f, hi = 4.0f * 96.0f * 96.0f;
  return std::min(std::max(sq, lo), hi);
}

}  // namespace

extern "C" {

// joints: (n_people, n_joints, 2) float, working-image pixel coords
// vis:    (n_people, n_joints) uint8 or nullptr (all visible)
// out:    (n_joints, hm_h, hm_w) float, caller-zeroed
// augment: 0 = clean gaussians; 1 = reference-style heatmap augmentation
//          (peak scaling + occlusion rectangle), seeded by `seed`
void render_heatmaps(const float* joints, const uint8_t* vis, int n_people,
                     int n_joints, float* out, int hm_w, int hm_h,
                     float stride_x, float stride_y, float sigma_base,
                     int augment, uint64_t seed) {
  Rng rng(seed);
  for (int n = 0; n < n_people; ++n) {
    const float* pose = joints + n * n_joints * 2;
    float hs = 2.0f * human_scale(pose, n_joints, stride_x, stride_y);
    if (hs == 0.0f) continue;
    float cur_sigma = sigma_base * std::sqrt(hs / (96.0f * 96.0f));
    float tmp_size = cur_sigma * 3.0f;
    float inv_two_sig2 = 1.0f / (2.0f * cur_sigma * cur_sigma);

    for (int j = 0; j < n_joints; ++j) {
      if (vis && vis[n * n_joints + j] == 0) continue;
      int mu_x = (int)(pose[2 * j] / stride_x);
      int mu_y = (int)(pose[2 * j + 1] / stride_y);
      int ul_x = (int)(mu_x - tmp_size);
      int ul_y = (int)(mu_y - tmp_size);
      int br_x = (int)(mu_x + tmp_size + 1.0f);
      int br_y = (int)(mu_y + tmp_size + 1.0f);
      if (ul_x >= hm_w || ul_y >= hm_h || br_x < 0 || br_y < 0) continue;

      // gaussian centered at size//2 of the (2*tmp_size+1) window, exactly
      // like the numpy arange/floor arithmetic
      float size = 2.0f * tmp_size + 1.0f;
      float c0 = std::floor(size / 2.0f);

      float scale = 1.0f;
      // occlusion rectangle in WINDOW-local indices drawn from
      // heatmap-global ranges (reference quirk, JointsDataset.py:424-431);
      // empty by default
      int occ_y0 = 0, occ_y1 = 0, occ_x0 = 0, occ_x1 = 0;
      if (augment) {
        if (rng.uniform() < 0.6)
          scale = 0.9f + (float)rng.gauss() * 0.03f;
        if (j == 7 || j == 8) {  // wrist group
          if (rng.uniform() < 0.1) scale *= 0.5f;
        } else if (j == 9 || j == 10) {  // ankle group
          if (rng.uniform() < 0.1) scale *= 0.2f;
        } else {
          if (rng.uniform() < 0.05) scale *= 0.5f;
        }
        occ_y0 = (int)rng.uniform(0.0, hm_h - 1.0);
        occ_x0 = (int)rng.uniform(0.0, hm_w - 1.0);
        occ_y1 = (int)std::min(
            occ_y0 + rng.uniform(hm_h / 4.0, hm_h * 0.75), (double)hm_h);
        occ_x1 = (int)std::min(
            occ_x0 + rng.uniform(hm_w / 4.0, hm_w * 0.75), (double)hm_w);
      }

      int x0 = std::max(0, ul_x), x1 = std::min(br_x, hm_w);
      int y0 = std::max(0, ul_y), y1 = std::min(br_y, hm_h);
      float* plane = out + (size_t)j * hm_h * hm_w;
      for (int y = y0; y < y1; ++y) {
        int gy_loc = y - ul_y;
        float dy = (float)gy_loc - c0;
        float gy = dy * dy;
        bool occ_row = gy_loc >= occ_y0 && gy_loc < occ_y1;
        float* row = plane + (size_t)y * hm_w;
        for (int x = x0; x < x1; ++x) {
          int gx_loc = x - ul_x;
          if (occ_row && gx_loc >= occ_x0 && gx_loc < occ_x1) continue;
          float dx = (float)gx_loc - c0;
          float g = std::exp(-(dx * dx + gy) * inv_two_sig2) * scale;
          g = std::min(g, 1.0f);
          if (g > row[x]) row[x] = g;
        }
      }
    }
  }
  // final clip to [0, 1] (values already bounded; guard for completeness)
  size_t total = (size_t)n_joints * hm_h * hm_w;
  for (size_t i = 0; i < total; ++i) {
    out[i] = std::min(std::max(out[i], 0.0f), 1.0f);
  }
}

// Batched multi-view renderer: joints per view with per-view visibility.
// all_joints: (n_views, n_people, n_joints, 2); all_vis likewise (or null).
// out: (n_views, n_joints, hm_h, hm_w), caller-zeroed.
void render_heatmaps_views(const float* all_joints, const uint8_t* all_vis,
                           int n_views, int n_people, int n_joints,
                           float* out, int hm_w, int hm_h, float stride_x,
                           float stride_y, float sigma_base, int augment,
                           uint64_t seed) {
  for (int v = 0; v < n_views; ++v) {
    render_heatmaps(all_joints + (size_t)v * n_people * n_joints * 2,
                    all_vis ? all_vis + (size_t)v * n_people * n_joints
                            : nullptr,
                    n_people, n_joints,
                    out + (size_t)v * n_joints * hm_h * hm_w, hm_w, hm_h,
                    stride_x, stride_y, sigma_base, augment,
                    seed + (uint64_t)v * 0x9E3779B97F4A7C15ULL);
  }
}

}  // extern "C"

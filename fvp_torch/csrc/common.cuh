// Shared helpers of the port's kernels: plain C entry points (bound with
// ctypes), every launch on the caller's stream, and every entry returns
// cudaGetLastError() so that the Python wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FVP_API extern "C" __attribute__((visibility("default")))

namespace fvp {

// Bilinear sample of one (H, W) map at pixel (x, y), align_corners pixel
// space, zero contribution from out-of-bounds corners. The four corner
// terms are summed in the order of the plain version (ops/sampling.py).
__device__ __forceinline__ float corner_val(const float* __restrict__ h,
                                            int H, int W, int xi, int yi) {
  return (xi >= 0 && xi < W && yi >= 0 && yi < H) ? __ldg(h + yi * W + xi)
                                                  : 0.f;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ h, int H,
                                          int W, float x, float y) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx1 = x - x0, wy1 = y - y0;
  const int xi = (int)x0, yi = (int)y0;
  float out = corner_val(h, H, W, xi, yi) * ((1.f - wx1) * (1.f - wy1));
  out += corner_val(h, H, W, xi + 1, yi) * (wx1 * (1.f - wy1));
  out += corner_val(h, H, W, xi, yi + 1) * ((1.f - wx1) * wy1);
  out += corner_val(h, H, W, xi + 1, yi + 1) * (wx1 * wy1);
  return out;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

}  // namespace fvp

// K1 whole_sample: whole-space aggregation of the view heatmaps.
//
// Replaces fvp_tpu/ops/pallas/sampler.py::pallas_tiled_sample (driven by
// fast_sampling.py::project_whole_pallas_batched). The TPU kernel turns the
// bilinear gather into band-limited hat-function matmuls on bf16 heatmaps,
// because a TPU gather runs at DMA latency. On Hopper a gather is cheap, so
// this kernel samples exactly: a 4-corner bilinear gather in every view at
// the precomputed coords (rc.whole_sample_px), the view mean, then a clamp
// to [0, 1]. No y-band, no bf16.
//
// Bound on the H100: bytes. It reads the heatmaps (9.2 MB at the flagship
// shape) and the coords (5.1 MB) and writes the (B, 80, 80, 20, J) volume
// (7.7 MB): 22 MB, 6.6 us at 3.35 TB/s; the arithmetic is ~8 flops per
// gathered value. What holds it back is the gather's L1/L2 sector traffic
// (4 corners x J planes x V views per voxel), not DRAM. Design:
// - one thread per (item, voxel), the J joints' running sums in registers
//   (the kernel is built for J = 15 and 17): each view's (x, y) is loaded
//   once (coalesced), and the floor, the four corner weights and
//   validities are computed once for all J planes;
// - neighbouring lanes take neighbouring voxels along z, whose projections
//   lie close together in each plane, so a warp's gathers of one plane
//   share L1/L2 lines (the heatmaps sit in the 50 MB L2);
// - the block's 256 x J outputs are one contiguous run of the volume:
//   staged in shared memory (stride J, odd: no bank conflicts) and written
//   with coalesced 16-byte stores.
// The corner order and the view order are the plain version's
// (fvp::bilinear, ops/sampling.py).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int J>
__global__ void __launch_bounds__(kThreads)
whole_sample_kernel(const float* __restrict__ hm, const float* __restrict__ px,
                    float* __restrict__ out, int V, int H, int W, int N,
                    bool view_sum) {
  __shared__ float stage[kThreads * J];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kThreads, n = n0 + threadIdx.x;
  const int count = min(kThreads, N - n0);
  if (n < N) {
    float acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.f;
    const long long plane = (long long)H * W;
    for (int v = 0; v < V; ++v) {
      const float x = __ldg(px + (2LL * v) * N + n);
      const float y = __ldg(px + (2LL * v + 1) * N + n);
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx1 = x - x0, wy1 = y - y0;
      const int xi = (int)x0, yi = (int)y0;
      const float w00 = (1.f - wx1) * (1.f - wy1), w10 = wx1 * (1.f - wy1);
      const float w01 = (1.f - wx1) * wy1, w11 = wx1 * wy1;
      const bool x0ok = xi >= 0 && xi < W, x1ok = xi + 1 >= 0 && xi + 1 < W;
      const bool y0ok = yi >= 0 && yi < H, y1ok = yi + 1 >= 0 && yi + 1 < H;
      const bool ok00 = x0ok && y0ok, ok10 = x1ok && y0ok;
      const bool ok01 = x0ok && y1ok, ok11 = x1ok && y1ok;
      const int o00 = yi * W + xi;
      const float* h = hm + ((long long)b * V + v) * J * plane;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float* p = h + j * plane + o00;
        float s = (ok00 ? __ldg(p) : 0.f) * w00;
        s += (ok10 ? __ldg(p + 1) : 0.f) * w10;
        s += (ok01 ? __ldg(p + W) : 0.f) * w01;
        s += (ok11 ? __ldg(p + W + 1) : 0.f) * w11;
        acc[j] += s;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
      stage[threadIdx.x * J + j] =
          view_sum ? acc[j] : fvp::clampf(acc[j] / (float)V, 0.f, 1.f);
  }
  __syncthreads();
  // the block's rows are out[b, n0 .. n0+count, :]: one contiguous run
  float* dst = out + ((long long)b * N + n0) * J;
  const int total = count * J;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < total / 4; i += kThreads)
      d4[i] = make_float4(stage[4 * i], stage[4 * i + 1], stage[4 * i + 2],
                          stage[4 * i + 3]);
    done = total / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < total; i += kThreads) dst[i] = stage[i];
}

}  // namespace

// hm (B, V, J, H, W); px (V, 2, N); out (B, N, J), N = nx*ny*nz x-major.
// J is 15 or 17. view_sum != 0 writes the view sum (no mean, no clamp).
FVP_API int fvp_whole_sample(const float* hm, const float* px, float* out,
                             int B, int V, int J, int H, int W, int N,
                             int view_sum, void* stream) {
  if (B <= 0 || N <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (J == 15)
    whole_sample_kernel<15><<<grid, kThreads, 0, st>>>(hm, px, out, V, H, W,
                                                       N, view_sum != 0);
  else if (J == 17)
    whole_sample_kernel<17><<<grid, kThreads, 0, st>>>(hm, px, out, V, H, W,
                                                       N, view_sum != 0);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

FVP_API const char* fvp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

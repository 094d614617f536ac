// stem: the backbone stem, conv1 (7x7, stride 2, pad 3, 3 -> 64) + folded
// bn1 affine + ReLU + 3x3 / stride-2 / pad-1 max pool, NHWC, bf16 out.
//
// Replaces fvp_tpu/ops/pallas/stem.py::pallas_stem. The TPU kernel reads a
// host space-to-depth frame padded to 16 lanes so its matrix unit sees a
// wide contraction; here the kernel reads the NHWC float32 image directly.
// Numerics are the TPU kernel's: image and weights rounded to bf16,
// products summed in float32 (a product of two bf16 values is exact in
// float32), the affine and ReLU on the float32 sum, the 3x3 max over conv
// rows and columns {2p-1, 2p, 2p+1} that lie inside the conv map, and the
// pooled value rounded to bf16.
//
// Bound on the H100: memory, 29.5 MB of image in and 19.7 MB of pooled map
// out at the flagship (5, 512, 960, 3) input; the conv is 1.16e10 float32
// operations, about 0.17 ms at the card's non-tensor float32 peak, so this
// SIMT kernel is bound by its arithmetic. Design: a block owns an 8 x 7
// tile of pooled outputs for all 64 channels. It stages its 39 x 35 x 3
// input patch (zero outside the image) and the 147 x 64 weights in shared
// memory as floats, computes the 17 x 15 conv tile that the tile's pool
// windows cover (one-row and one-column halo) with each thread holding
// 8 positions x 8 channels in registers, writes the activated conv tile
// over the operands in shared memory, and takes the pool there. Only the
// pooled map reaches device memory.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kF = 64, kTaps = 7 * 7 * 3;
constexpr int TPH = 8, TPW = 7;                   // pooled tile
constexpr int CR = 2 * TPH + 1, CC = 2 * TPW + 1; // conv tile 17 x 15
constexpr int NP = CR * CC;                       // 255 conv positions
constexpr int IR = 4 * TPH + 7, IC = 4 * TPW + 7; // input patch 39 x 35
constexpr int kThreads = 256;
constexpr int kPos = 8;                           // positions per thread
constexpr int kIn = (IR * IC * 3 + 3) / 4 * 4;     // float4-aligned weights
constexpr int kOperands = kIn + kTaps * kF;
constexpr int kUnion = (kOperands > NP * kF) ? kOperands : NP * kF;
constexpr size_t kSmemBytes = sizeof(float) * (kUnion + 2 * kF);
static_assert(32 * kPos >= NP, "positions per thread");

__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ aff, __nv_bfloat16* __restrict__ out,
            int H, int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ __align__(16) float sm[];
  float* in = sm;                                 // (IR, IC, 3)
  float* ws = sm + kIn;                           // (147, 64)
  float* conv = sm;                               // (NP, 64), after the conv
  float* sa = sm + kUnion;                        // (2, 64)
  const int tid = threadIdx.x, b = blockIdx.z;
  const int py0 = blockIdx.y * TPH, px0 = blockIdx.x * TPW;
  const int gy0 = 4 * py0 - 5, gx0 = 4 * px0 - 5;

  const float* xb = x + (long long)b * H * W * 3;
  for (int i = tid; i < IR * IC * 3; i += kThreads) {
    const int lr = i / (IC * 3), rem = i % (IC * 3);
    const int gy = gy0 + lr, gx = gx0 + rem / 3;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(xb + ((long long)gy * W + gx) * 3 + rem % 3);
    in[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(w);
  for (int i = tid; i < kTaps * kF / 2; i += kThreads) {
    const float2 v = __bfloat1622float2(w2[i]);
    ws[2 * i] = v.x;
    ws[2 * i + 1] = v.y;
  }
  if (tid < 2 * kF) sa[tid] = aff[tid];
  __syncthreads();

  // conv: channels [8cg, 8cg+8) at positions pg + 32i
  const int cg = tid & 7, pg = tid >> 3;
  int base[kPos];
#pragma unroll
  for (int i = 0; i < kPos; ++i) {
    const int pos = min(pg + 32 * i, NP - 1);     // the one spare recomputes
    base[i] = (2 * (pos / CC) * IC + 2 * (pos % CC)) * 3;
  }
  float acc[kPos][8];
#pragma unroll
  for (int i = 0; i < kPos; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const float4* ws4 = reinterpret_cast<const float4*>(ws) + cg * 2;
  for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int tap = (ky * 7 + kx) * 3 + c;
        const float4 w0 = ws4[tap * (kF / 4)], w1 = ws4[tap * (kF / 4) + 1];
        const int off = (ky * IC + kx) * 3 + c;
#pragma unroll
        for (int i = 0; i < kPos; ++i) {
          const float v = in[base[i] + off];
          acc[i][0] += v * w0.x;
          acc[i][1] += v * w0.y;
          acc[i][2] += v * w0.z;
          acc[i][3] += v * w0.w;
          acc[i][4] += v * w1.x;
          acc[i][5] += v * w1.y;
          acc[i][6] += v * w1.z;
          acc[i][7] += v * w1.w;
        }
      }
    }
  }
  __syncthreads();                                // operands are dead now

#pragma unroll
  for (int i = 0; i < kPos; ++i) {
    const int pos = pg + 32 * i;
    if (pos < NP) {
      float h[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int f = cg * 8 + c;
        h[c] = fmaxf(acc[i][c] * sa[f] + sa[kF + f], 0.f);
      }
      float4* dst = reinterpret_cast<float4*>(conv + pos * kF + cg * 8);
      dst[0] = make_float4(h[0], h[1], h[2], h[3]);
      dst[1] = make_float4(h[4], h[5], h[6], h[7]);
    }
  }
  __syncthreads();

  // pool: conv rows/cols {2p-1, 2p, 2p+1} inside [0, Hc) x [0, Wc)
  const int f = tid % kF;
  for (int q = tid / kF; q < TPH * TPW; q += kThreads / kF) {
    const int ly = q / TPW, lx = q % TPW;
    const int py = py0 + ly, px = px0 + lx;
    if (py >= Hp || px >= Wp) continue;
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int cy = 2 * py - 1 + dy;
      if (cy < 0 || cy >= Hc) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int cx = 2 * px - 1 + dx;
        if (cx < 0 || cx >= Wc) continue;
        m = fmaxf(m, conv[((2 * ly + dy) * CC + 2 * lx + dx) * kF + f]);
      }
    }
    out[(((long long)b * Hp + py) * Wp + px) * kF + f] = __float2bfloat16_rn(m);
  }
}

}  // namespace

// x (N, H, W, 3) float32; w (7, 7, 3, 64) bf16; aff (2, 64) float32 (scale,
// shift); out (N, Hp, Wp, 64) bf16 with Hc = (H-1)/2 + 1, Hp = (Hc-1)/2 + 1
// (likewise W).
FVP_API int fvp_stem(const float* x, const void* w, const float* aff,
                     void* out, int N, int H, int W, int Hc, int Wc, int Hp,
                     int Wp, void* stream) {
  if (N <= 0 || Hp <= 0 || Wp <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Wp + TPW - 1) / TPW, (Hp + TPH - 1) / TPH, N);
  stem_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      x, static_cast<const __nv_bfloat16*>(w), aff,
      static_cast<__nv_bfloat16*>(out), H, W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
}

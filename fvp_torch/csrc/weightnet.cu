// K5 weightnet_pool: WeightNet's conv front end, fused.
//
// Replaces fvp_tpu/ops/pallas/weightnet.py::pallas_weightnet_pool. Per
// (plane stack n, joint j) map of A x B cells: a 3x3 SAME conv with one
// input channel and C = 32 filters, the folded conv-bias + BN affine, a
// 2x2 / stride-2 max pool, ReLU, and the mean over the pooled map -> (N, J,
// C). pool(relu(.)) == relu(pool(.)) since both are monotone.
//
// Bound on the H100: float32 operations (N*J*A*B*C*(9*2 + 2) = 1.18 GFLOP
// at the flagship (30, 64, 64, 15) input, 0.0176 ms at 67 TFLOP/s, against
// 7.4 MB read). The TPU kernel turns the Cin=1 conv into a block-diagonal
// matmul that is 15x structural zeros, to feed its matrix unit; here it is
// a direct conv in float32 FMAs (the port's float32 tolerance rules out
// TF32 or bf16 tensor cores). The (N*J, A, B, C) activation (236 MB in
// float32) never reaches memory. Design (ops/kernels/weightnet.py::
// weightnet_plan picks the band):
// - one block per (n, band of `rows` map rows): it reads the band's pixel
//   rows plus a one-row halo, all J joints at once, as contiguous 16-byte
//   loads (a (rows + 2) x B x J slab of the (N, A, B, J) planes), and
//   transposes them into joint-major zero-padded tiles in shared memory
//   (where a band of all joints would not fit, as at 256 x 256 x 96, a
//   block takes a chunk of `joints` joints and reads runs of them);
// - a thread owns one joint and a group of 4 of the C channels: their 9
//   taps and affine sit in registers, its 4 running sums too (the channel
//   loop is unrolled, so no local memory), and it reads each 4x4 patch of
//   a pooled cell once (eight 8-byte loads) for all 4 channels; `reps`
//   threads share a (joint, group) and take its cells in turn. Groups of 4
//   rather than 8 keep a thread under 128 registers, so a block holds 480
//   threads (15 warps) to hide the FMA and shared-load latency. The affine
//   follows the 2x2 max (exact: see the cell loop), one multiply and add
//   per pooled cell and channel instead of four;
// - the mean in a fixed order: the band's sums (over the reps, in order)
//   go to a scratch tensor, and the last block of each n to finish (a
//   counter, reset by that block) adds the bands in band order, so two
//   calls give the same bits.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kC = 32;
constexpr int kG = 4;                    // channels of a thread
constexpr int kCG = kC / kG;             // channel groups
constexpr int kMaxThreads = 512;         // <= 128 registers a thread

__device__ __forceinline__ uint32_t magic(uint32_t d) {
  return (uint32_t)((0x100000000ull + d - 1) / d);
}

__global__ void __launch_bounds__(kMaxThreads) weightnet_pool_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ shift,
    float* __restrict__ partial, unsigned* __restrict__ counters,
    float* __restrict__ out, int A, int B, int J, int rows, int bands,
    int joints, int reps, int plane, int vec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int jblocks = (J + joints - 1) / joints;
  const int jb = blockIdx.x % jblocks, nb = blockIdx.x / jblocks;
  const int n = nb / bands, band = nb - n * bands;
  const int j0 = jb * joints, jn = min(joints, J - j0);
  const int y0 = band * rows, bh = min(rows, A - y0);
  const int Bp = B + 2, W = B * jn;
  float* tile = sm;                  // (joints, rows + 2, B + 2), stride plane
  float* red = sm + joints * plane;  // (threads, kG)

  // tile row r holds map row y0 - 1 + r; halo columns and rows outside the
  // map are zero
  const int ylo = max(y0 - 1, 0), yhi = min(y0 + bh + 1, A);
  const int rlo = ylo - (y0 - 1);
  for (int i = tid; i < jn * (bh + 2); i += nthreads) {
    const int j = i / (bh + 2), r = i - j * (bh + 2);
    tile[j * plane + r * Bp] = 0.f;
    tile[j * plane + r * Bp + B + 1] = 0.f;
  }
  if (y0 == 0)
    for (int i = tid; i < jn * B; i += nthreads)
      tile[(i / B) * plane + 1 + i % B] = 0.f;
  if (y0 + bh == A)
    for (int i = tid; i < jn * B; i += nthreads)
      tile[(i / B) * plane + (bh + 1) * Bp + 1 + i % B] = 0.f;
  // the slab of map rows ylo .. yhi - 1, joints j0 .. j0 + jn - 1: element
  // e is (row e / W, pixel, joint), the divisions by multiplication
  const float* src = x + ((long long)n * A + ylo) * B * J + j0;
  const int len = (yhi - ylo) * W;
  const uint32_t mw = magic(W), mj = magic(jn);
  auto put = [&](int e, float v) {
    const int r = __umulhi((uint32_t)e, mw), rem = e - r * W;
    const int xx = __umulhi((uint32_t)rem, mj), j = rem - xx * jn;
    tile[j * plane + (rlo + r) * Bp + xx + 1] = v;
  };
  if (vec && jn == J) {              // the whole slab, 16-byte loads
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = tid; i < len / 4; i += nthreads) {
      const float4 v = __ldg(s4 + i);
      put(4 * i, v.x);
      put(4 * i + 1, v.y);
      put(4 * i + 2, v.z);
      put(4 * i + 3, v.w);
    }
  } else {                           // runs of jn joints per pixel
    for (int i = tid; i < len; i += nthreads) {
      const int p = __umulhi((uint32_t)i, mj);
      put(i, __ldg(src + (long long)p * J + (i - p * jn)));
    }
  }

  // this thread: joint j, channels cg * kG + [0, kG), cells r, r + reps, ..
  const int cg = tid % kCG, rep = (tid / kCG) % reps, j = tid / (kCG * reps);
  float wr[9][kG], sc[kG], sh[kG], sum[kG];
#pragma unroll
  for (int c = 0; c < kG; ++c) {
#pragma unroll
    for (int t = 0; t < 9; ++t) wr[t][c] = __ldg(w + t * kC + cg * kG + c);
    sc[c] = __ldg(scale + cg * kG + c);
    sh[c] = __ldg(shift + cg * kG + c);
    sum[c] = 0.f;
    // a negative scale: negated taps and scale give the same y_i, and
    // then y = fl(fl(a s) + b) grows with a (see the cell loop)
    if (sc[c] < 0.f) {
#pragma unroll
      for (int t = 0; t < 9; ++t) wr[t][c] = -wr[t][c];
      sc[c] = -sc[c];
    }
  }
  __syncthreads();

  const int Bq = B / 2, cells = (bh / 2) * Bq;
  const float* tj = tile + j * plane;
  int py = rep / Bq, px = rep - (rep / Bq) * Bq;
  for (int q = j < jn ? rep : cells; q < cells; q += reps) {
    float pt[4][4];                      // the 4x4 padded patch
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 a =
          *reinterpret_cast<const float2*>(tj + (2 * py + r) * Bp + 2 * px);
      const float2 b = *reinterpret_cast<const float2*>(
          tj + (2 * py + r) * Bp + 2 * px + 2);
      pt[r][0] = a.x;
      pt[r][1] = a.y;
      pt[r][2] = b.x;
      pt[r][3] = b.y;
    }
    // the affine after the 2x2 max: with sc >= 0, fl(fl(a sc) + sh) is
    // monotone in a, so max_i fl(fl(a_i sc) + sh) = fl(fl(max_i a_i sc) +
    // sh), bit for bit the plain version's max of the affine outputs
#pragma unroll
    for (int c = 0; c < kG; ++c) {
      float m = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          float a = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t)
            a = fmaf(pt[dy + t / 3][dx + t % 3], wr[t][c], a);
          m = fmaxf(m, a);
        }
      sum[c] += fmaxf(__fadd_rn(__fmul_rn(m, sc[c]), sh[c]), 0.f);
    }
    px += reps;
    while (px >= Bq) {
      px -= Bq;
      ++py;
    }
  }

  // the band's sums: the reps of each (joint, group) in order
#pragma unroll
  for (int c = 0; c < kG; ++c) red[tid * kG + c] = sum[c];
  __syncthreads();
  float* part = partial + (((long long)n * bands + band) * J + j0) * kC;
  for (int u = tid; u < jn * kC; u += nthreads) {
    const int jj = u / kC, c = u - jj * kC, g = c / kG, k = c - g * kG;
    float a = 0.f;
    for (int r = 0; r < reps; ++r)
      a += red[(((jj * reps + r) * kCG) + g) * kG + k];
    part[u] = a;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(counters + n, 1u) == (unsigned)(bands * jblocks) - 1;
  __syncthreads();
  if (!last) return;
  // the last block of map n: the bands in order, then the mean
  __threadfence();
  const float* pn = partial + (long long)n * bands * J * kC;
  const float ncells = (float)((A / 2) * Bq);
  for (int u = tid; u < J * kC; u += nthreads) {
    float a = 0.f;
#pragma unroll 4
    for (int b = 0; b < bands; ++b) a += __ldcg(pn + (long long)b * J * kC + u);
    out[(long long)n * J * kC + u] = a / ncells;
  }
  if (tid == 0) counters[n] = 0;         // ready for the next call
}

}  // namespace

// x (N, A, B, J); w (9, C) taps row-major over (dy, dx); scale, shift (C,);
// partial (N, bands, J, C) scratch; counters (N,) zero on entry (and left
// zero); out (N, J, C). C == 32, A, B and rows even; one block per (n,
// band, chunk of `joints` joints) of joints * 4 * reps threads with `smem`
// bytes of shared memory (`plane` floats per joint tile):
// ops/kernels/weightnet.py::weightnet_plan.
FVP_API int fvp_weightnet_pool(const float* x, const float* w,
                               const float* scale, const float* shift,
                               float* partial, unsigned* counters, float* out,
                               int N, int A, int B, int J, int C, int rows,
                               int bands, int joints, int reps, int plane,
                               int smem, void* stream) {
  const int threads = joints * kCG * reps;
  if (C != kC || A % 2 || B % 2 || rows % 2 || rows <= 0 || J <= 0 ||
      joints <= 0 || joints > J || reps <= 0 || threads > kMaxThreads ||
      bands != (A + rows - 1) / rows ||
      // the slab's index divisions by multiplication stay exact
      (long long)(rows + 2) * B * joints * B * joints >= (1ll << 32) ||
      plane < (rows + 2) * (B + 2) || plane % 2 ||
      (size_t)smem < sizeof(float) * ((size_t)joints * plane + threads * kG))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        weightnet_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec =
      (B * J) % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int jblocks = (J + joints - 1) / joints;
  weightnet_pool_kernel<<<N * bands * jblocks, threads, smem,
                          (cudaStream_t)stream>>>(
      x, w, scale, shift, partial, counters, out, A, B, J, rows, bands,
      joints, reps, plane, vec);
  return (int)cudaGetLastError();
}

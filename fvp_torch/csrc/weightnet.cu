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

#include <cuda_bf16.h>
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

// a plane's element from a float32 input: the float32 kernel's as it is,
// the bf16 kernel's rounded to nearest
template <typename T>
__device__ __forceinline__ T to_tile(float v);
template <>
__device__ __forceinline__ float to_tile<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_tile<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A band's slab into zero-padded, joint-major planes, for both pool
// kernels: plane j (at stride `plane`) holds joint j0 + j of image n of
// the (N, A, B, J) input as (bh + 2) x (B + 2), row r the map's row
// y0 - 1 + r; the halo columns and rows outside the map are zero. The
// slab of map rows ylo .. yhi - 1, joints j0 .. j0 + jn - 1, is read in
// element order, e = (row e / W, pixel, joint), the divisions by
// multiplication: with vec and all J joints one contiguous run of 16-byte
// loads, else runs of jn joints a pixel.
template <typename T>
__device__ __forceinline__ void stage_slab(T* tile,
                                           const float* __restrict__ x,
                                           int n, int A, int B, int J,
                                           int j0, int jn, int y0, int bh,
                                           int plane, int vec) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int Bp = B + 2, W = B * jn;
  const T zero = to_tile<T>(0.f);
  const int ylo = max(y0 - 1, 0), yhi = min(y0 + bh + 1, A);
  const int rlo = ylo - (y0 - 1);
  for (int i = tid; i < jn * (bh + 2); i += nthreads) {
    const int j = i / (bh + 2), r = i - j * (bh + 2);
    tile[j * plane + r * Bp] = zero;
    tile[j * plane + r * Bp + B + 1] = zero;
  }
  if (y0 == 0)
    for (int i = tid; i < jn * B; i += nthreads)
      tile[(i / B) * plane + 1 + i % B] = zero;
  if (y0 + bh == A)
    for (int i = tid; i < jn * B; i += nthreads)
      tile[(i / B) * plane + (bh + 1) * Bp + 1 + i % B] = zero;
  const float* src = x + ((long long)n * A + ylo) * B * J + j0;
  const int len = (yhi - ylo) * W;
  const uint32_t mw = magic(W), mj = magic(jn);
  // a / jn (magic(1) would wrap to 0)
  auto div_j = [&](int a) {
    return jn == 1 ? a : (int)__umulhi((uint32_t)a, mj);
  };
  auto put = [&](int e, float v) {
    const int r = __umulhi((uint32_t)e, mw), rem = e - r * W;
    const int xx = div_j(rem), j = rem - xx * jn;
    tile[j * plane + (rlo + r) * Bp + xx + 1] = to_tile<T>(v);
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
      const int p = div_j(i);
      put(i, __ldg(src + (long long)p * J + (i - p * jn)));
    }
  }
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
  const int Bp = B + 2;
  float* tile = sm;                  // (joints, rows + 2, B + 2), stride plane
  float* red = sm + joints * plane;  // (threads, kG)

  stage_slab(tile, x, n, A, B, J, j0, jn, y0, bh, plane, vec);

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


// ---------------------------------------------------------------------------
// K5's bf16 route: the arithmetic of the TPU kernel itself.
//
// fvp_tpu/ops/pallas/weightnet.py::pallas_weightnet_pool computes in bf16
// inside (_weightnet_kernel): the padded planes round to bf16, the grouped
// 3x3 conv is a bf16 (9J, J C) matrix product with float32 sums, the
// affine and ReLU are float32, the result rounds to bf16 and is max pooled
// 2x2 in bf16, and the mean over the pooled map is taken in float32. Here
// the conv of one (n, j) map is a GEMM of (pixels) x (16 taps, 9 of them
// real) by (16 taps) x (C = 32 channels) on mma.sync m16n8k16 (bf16
// operands, float32 sums): the block-diagonal zeros of the TPU's matrix
// are never formed.
//
// Bound on the H100: bytes (the 7.4 MB float32 planes at the flagship
// (30, 64, 64, 15), 2.2 us at 3.35 TB/s; its 0.53 GFLOP of real products
// are 0.5 us at 989 TFLOP/s bf16). The route's first kernel ran one block
// per (n, j) map and read the planes at a stride of J floats, one useful
// value a 32-byte sector (144-216 GB/s of its input on an NVIDIA H100
// 80GB HBM3 at 700 W). Design, after the float32
// kernel above (ops/kernels/weightnet.py::weightnet_bf16_plan picks the
// band):
// - one block per (n, band of `rows` map rows), or per (n, band, chunk of
//   `joints` joints) where a band of all joints would not fit: it reads the
//   band's rows plus a one-row halo as contiguous 16-byte loads (a
//   (rows + 2) x B x J slab of the (N, A, B, J) planes; runs of the chunk's
//   joints where chunked), rounds them to bf16 and transposes them into
//   zero-padded, joint-major (rows + 2) x (B + 2) tiles in shared memory;
// - a warp takes one joint of the band at a time (its `warps` warps the
//   joints w, w + warps, ...) in patches of 2 rows x 16 columns, two M
//   tiles of the even and the odd columns: a thread's accumulator rows g
//   and g + 8 of both are the four pixels of pooling window g, so the 2x2
//   max is three fmaxf in registers and every lane pools a window; the
//   affine, ReLU and bf16 rounding follow the max (exact: they are
//   monotone, a channel with a negative scale taking its taps negated), one
//   per pooled cell instead of four; the A fragments are read straight
//   from the tile (tap t = 3 dy + dx is an offset), the B fragments (all
//   32 channels) sit in registers;
// - the mean in a fixed order: each thread sums its pooled cells in patch
//   order, the warp adds its lanes by a fixed butterfly, the band's sums
//   go to a scratch tensor, and the last block of each n to finish (a
//   counter, reset by that block) adds the bands in band order, so two
//   calls give the same bits.
constexpr int kB16MaxWarps = 16;

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kB16MaxWarps * 32)
    weightnet_pool_bf16_kernel(const float* __restrict__ x,
                               const __nv_bfloat16* __restrict__ w,
                               const float* __restrict__ aff,
                               float* __restrict__ partial,
                               unsigned* __restrict__ counters,
                               float* __restrict__ out, int A, int B, int J,
                               int rows, int bands, int joints, int plane,
                               int vec) {
  extern __shared__ __align__(16) unsigned char smraw[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smraw);
  __shared__ int last;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int jblocks = (J + joints - 1) / joints;
  const int jb = blockIdx.x % jblocks, nb = blockIdx.x / jblocks;
  const int n = nb / bands, band = nb - n * bands;
  const int j0 = jb * joints, jn = min(joints, J - j0);
  const int y0 = band * rows, bh = min(rows, A - y0);
  const int Bp = B + 2;
  const __nv_bfloat16 zero = __ushort_as_bfloat16((unsigned short)0);

  stage_slab(tile, x, n, A, B, J, j0, jn, y0, bh, plane, vec);

  // B fragments of the 4 n8 tiles: taps k = 2t, 2t + 1 (b0) and 2t + 8,
  // 2t + 9 (b1) of channel 8 nt + g; w is (16, C) with taps 9.. zero.
  // A channel with a negative scale takes its taps negated and |scale|:
  // its conv outputs negate exactly (the mma's sums round symmetrically)
  // and fl(fl(a s) + b) is unchanged (see the cell loop)
  uint32_t b0[4], b1[4];
  float sc[8], sh[8];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int ch = 8 * nt + g;
    const uint32_t neg = __ldg(aff + ch) < 0.f ? 0x80008000u : 0u;
    b0[nt] = bf16_pair(w[(2 * t) * kC + ch], w[(2 * t + 1) * kC + ch]) ^ neg;
    b1[nt] =
        bf16_pair(w[(2 * t + 8) * kC + ch], w[(2 * t + 9) * kC + ch]) ^ neg;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[2 * nt + e] = fabsf(__ldg(aff + 8 * nt + 2 * t + e));
      sh[2 * nt + e] = __ldg(aff + kC + 8 * nt + 2 * t + e);
    }
  }
  // this thread's taps in the tile: k -> (k / 3) rows + k % 3 columns
  int off[4];
  bool real[4];
  {
    const int ks[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      real[q] = ks[q] < 9;
      off[q] = real[q] ? (ks[q] / 3) * Bp + ks[q] % 3 : 0;
    }
  }
  __syncthreads();

  // a patch: 2 rows x 16 columns, as two M tiles, the even columns and the
  // odd ones; a thread's rows g and g + 8 of both are pooling window g's
  // four pixels
  const int cols = (B + 15) / 16, patches = (bh / 2) * cols;
  float* part = partial + (((long long)n * bands + band) * J + j0) * kC;
  for (int jj = warp; jj < jn; jj += warps) {
    const __nv_bfloat16* tj = tile + jj * plane;
    float sum[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) sum[q] = 0.f;
    int py = 0, pc = 0;
    for (int p = 0; p < patches; ++p) {
      const int px = 16 * pc + 2 * g;            // the window's left column
      const bool valid = px < B;
      // the window's top-left pixel (py, px) has its 3x3 taps from tile
      // (py, px); the pixel below from tile row py + 1
      const __nv_bfloat16* top = tj + py * Bp + px;
      const __nv_bfloat16* bot = top + Bp;
      uint32_t a[2][4];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        __nv_bfloat16 v[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = valid && real[q] ? top[off[q] + dx] : zero;
          v[4 + q] = valid && real[q] ? bot[off[q] + dx] : zero;
        }
        a[dx][0] = bf16_pair(v[0], v[1]);
        a[dx][1] = bf16_pair(v[4], v[5]);
        a[dx][2] = bf16_pair(v[2], v[3]);
        a[dx][3] = bf16_pair(v[6], v[7]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_16816(c0, a[0][0], a[0][1], a[0][2], a[0][3], b0[nt], b1[nt]);
        mma_16816(c1, a[1][0], a[1][1], a[1][2], a[1][3], b0[nt], b1[nt]);
        // channels 8 nt + 2t + e: the window's max, then the affine, ReLU
        // and bf16 rounding. With sc >= 0, bf16(relu(fl(fl(a sc) + sh)))
        // grows with a, so it is the max of the four pixels' rounded
        // values, bit for bit the TPU kernel's order
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 2 * nt + e;
          const float m =
              fmaxf(fmaxf(c0[e], c0[2 + e]), fmaxf(c1[e], c1[2 + e]));
          const float y = __bfloat162float(__float2bfloat16_rn(
              fmaxf(__fadd_rn(__fmul_rn(m, sc[q]), sh[q]), 0.f)));
          if (valid) sum[q] += y;
        }
      }
      if (++pc == cols) {
        pc = 0;
        py += 2;
      }
    }
    // the windows g of each channel column t, in a fixed butterfly; lanes
    // 0-3 hold the joint's band sums of channels 8 nt + 2t + e
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float s = sum[q];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) part[jj * kC + 8 * (q >> 1) + 2 * t + (q & 1)] = s;
    }
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
  const float ncells = (float)((A / 2) * (B / 2));
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

// The bf16 route: x (N, A, B, J) float32; w (16, C) bf16, taps row-major
// over (dy, dx), rows 9.. zero; aff (2, C) float32 (scale, shift); partial
// (N, bands, J, C) scratch; counters (N,) zero on entry (and left zero);
// out (N, J, C) float32. C == 32, A, B and rows even; one block per (n,
// band, chunk of `joints` joints) of 32 `warps` threads with `smem` bytes
// of shared memory (`plane` bf16 per joint tile):
// ops/kernels/weightnet.py::weightnet_bf16_plan.
FVP_API int fvp_weightnet_pool_bf16(const float* x, const void* w,
                                    const float* aff, float* partial,
                                    unsigned* counters, float* out, int N,
                                    int A, int B, int J, int C, int rows,
                                    int bands, int joints, int warps,
                                    int plane, int smem, void* stream) {
  if (C != kC || N <= 0 || A % 2 || B % 2 || A < 2 || B < 2 || rows % 2 ||
      rows <= 0 || J <= 0 || joints <= 0 || joints > J || warps <= 0 ||
      warps > kB16MaxWarps || bands != (A + rows - 1) / rows ||
      // the slab's index divisions by multiplication stay exact
      (long long)(rows + 2) * B * joints * B * joints >= (1ll << 32) ||
      plane < (rows + 2) * (B + 2) ||
      (size_t)smem < 2 * (size_t)joints * plane || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        weightnet_pool_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec =
      (B * J) % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int jblocks = (J + joints - 1) / joints;
  weightnet_pool_bf16_kernel<<<N * bands * jblocks, 32 * warps, smem,
                               (cudaStream_t)stream>>>(
      x, static_cast<const __nv_bfloat16*>(w), aff, partial, counters, out,
      A, B, J, rows, bands, joints, plane, vec);
  return (int)cudaGetLastError();
}

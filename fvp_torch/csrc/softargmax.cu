// K4 soft_argmax: fused temperature soft-argmax over the tri-plane maps.
//
// Replaces fvp_tpu/ops/pallas/softargmax.py::pallas_soft_argmax. Per
// (plane s, person p) map of N = 64*64 cells and J joints:
//   m    = max_n x[n, j]
//   e    = exp(beta * x - beta * m)        (the peak probability is 1 / Z)
//   Z[j] = sum_n e[n, j]
//   out  = (sum_n e * grid[n, :]) / Z       the mm expectation
// and the per-person confidence, the mean of 1/Z over the 3 planes and the
// J joints (softargmax.py:75-77), all in one launch.
//
// Bound on the H100: bytes. It must read the (S, P, N, J) maps once (7.4
// MB at the flagship (3, 10, 4096, 15) input, 0.0022 ms at 3.35 TB/s); no
// probability tensor reaches memory. The TPU kernel takes one whole map
// per grid step; here one map per block would leave 30 blocks for 132 SMs.
// Design (ops/kernels/softargmax.py::softargmax_plan holds the tiling):
// - each map's N rows are split over G = ceil(N / 512) blocks of 128
//   threads (a compile-time size: 240 blocks at the flagship input), a
//   thread 4 consecutive rows: 4 J contiguous floats, J 16-byte loads all
//   in flight at once. lcm(4, J) = 4 J for odd J, so under the unrolled
//   loops every value's joint is a compile-time constant and the values
//   stay in registers: HBM is read once;
// - a block takes the max of its chunk per joint, then the exp-sums Z,
//   sum e gx, sum e gy relative to that max, from the registers: each
//   warp's by a reduce-scatter of shuffles (a lane trades half its values
//   at each step: one shuffle a value, not five), then the warps in order
//   through shared memory;
// - each block writes its (beta m, Z, sum e gx, sum e gy) per joint; the
//   last of a person's S x G blocks to finish (a counter per person, which
//   it resets) reads their partials into shared memory at once, rescales
//   each map's G partials by exp(beta m_g - beta m_map) and adds them in
//   block order, and takes the mean of 1/Z over the S planes and J joints
//   (a fixed tree). Every sum runs in a fixed order, so two calls give
//   the same bits.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                // the last block's loads in flight

// One halving step of a warp's reduce-scatter over C values a lane: lanes
// with bit `o` set keep the upper half, the others the lower half, each
// taking its partner's copy of the half it keeps (a fixed order of sums).
template <int C, bool kMax>
__device__ __forceinline__ void halve(float* a, int o, int lane) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const float send = up ? a[i] : a[i + C / 2];
    const float keep = up ? a[i + C / 2] : a[i];
    const float r = __shfl_xor_sync(0xffffffffu, send, o);
    a[i] = kMax ? fmaxf(keep, r) : keep + r;
  }
}

// The warp's max or sum of each of 16 Q values a lane in 16 Q shuffles
// (not 5 a value): afterwards lanes l and l ^ 1 hold the
// warp's reductions of values Q k .. Q k + Q - 1, k = (l >> 1) & 15, in
// a[0 .. Q - 1].
template <int Q, bool kMax>
__device__ __forceinline__ void warp_reduce_scatter(float* a, int lane) {
  halve<16 * Q, kMax>(a, 16, lane);
  halve<8 * Q, kMax>(a, 8, lane);
  halve<4 * Q, kMax>(a, 4, lane);
  halve<2 * Q, kMax>(a, 2, lane);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float r = __shfl_xor_sync(0xffffffffu, a[i], 1);
    a[i] = kMax ? fmaxf(a[i], r) : a[i] + r;
  }
}

template <int J>
__global__ void __launch_bounds__(kThreads)
soft_argmax_kernel(const float* __restrict__ planes,
                   const float* __restrict__ grid, float* __restrict__ partial,
                   unsigned* __restrict__ counters, float* __restrict__ coords,
                   float* __restrict__ confs, int S, int P, int N, int G,
                   float beta) {
  __shared__ float red[kWarps][3][J];
  __shared__ float mshared[J];
  __shared__ int last;
  extern __shared__ float4 parts4[];     // the last block's (S, G, 4, J)
  constexpr int T = kThreads;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int map = blockIdx.x / G, g = blockIdx.x - map * G;
  const int s = map / P, p = map - s * P;
  const int row0 = 4 * (g * T + tid);
  const bool live = row0 < N;            // N % 4 == 0: all 4 rows or none

  // the thread's 4 rows: v[r * J + j] = x[row0 + r, j]
  float v[4 * J];
  float gx[4], gy[4];
  if (live) {
    const float4* src = reinterpret_cast<const float4*>(
        planes + ((long long)map * N + row0) * J);
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const float4 q = __ldg(src + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
    const float4* gs = reinterpret_cast<const float4*>(
        grid + ((long long)s * N + row0) * 2);
    const float4 a = __ldg(gs), b = __ldg(gs + 1);
    gx[0] = a.x; gy[0] = a.y; gx[1] = a.z; gy[1] = a.w;
    gx[2] = b.x; gy[2] = b.y; gx[3] = b.z; gy[3] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4 * J; ++i) v[i] = -INFINITY;
#pragma unroll
    for (int r = 0; r < 4; ++r) gx[r] = gy[r] = 0.f;
  }

  // the block's max per joint: the thread's rows, the warp, the warps
  constexpr int QM = (J + 15) / 16, QS = (3 * J + 15) / 16;
  const int k0 = (lane >> 1) & 15;       // the lane's share of a scatter
  float m[16 * QM];
#pragma unroll
  for (int j = 0; j < 16 * QM; ++j)
    m[j] = j < J ? fmaxf(fmaxf(v[j], v[J + j]),
                         fmaxf(v[2 * J + j], v[3 * J + j])) : -INFINITY;
  warp_reduce_scatter<QM, true>(m, lane);
  if ((lane & 1) == 0) {
#pragma unroll
    for (int i = 0; i < QM; ++i)
      if (QM * k0 + i < J) red[warp][0][QM * k0 + i] = m[i];
  }
  __syncthreads();
  if (tid < J) {
    float a = red[0][0][tid];
    for (int w = 1; w < kWarps; ++w) a = fmaxf(a, red[w][0][tid]);
    // beta m, as the plain version's max of beta x (beta > 0: rounding
    // beta * x is monotone in x)
    mshared[tid] = __fmul_rn(a, beta);
  }
  __syncthreads();
  float mb[J];
#pragma unroll
  for (int j = 0; j < J; ++j) mb[j] = mshared[j];

  // exp-sums relative to the block's max, from the registers: acc[k J + j]
  // holds Z, sum e gx, sum e gy (k = 0, 1, 2) of joint j
  float acc[16 * QS];
#pragma unroll
  for (int i = 0; i < 16 * QS; ++i) acc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float e = expf(__fsub_rn(__fmul_rn(v[r * J + j], beta), mb[j]));
      acc[j] += e;
      acc[J + j] = fmaf(e, gx[r], acc[J + j]);
      acc[2 * J + j] = fmaf(e, gy[r], acc[2 * J + j]);
    }
  warp_reduce_scatter<QS, false>(acc, lane);
  if ((lane & 1) == 0) {                 // red's maxima were read above
    float* rw = &red[warp][0][0];
#pragma unroll
    for (int i = 0; i < QS; ++i)
      if (QS * k0 + i < 3 * J) rw[QS * k0 + i] = acc[i];
  }
  __syncthreads();
  // the block's partial: (beta m, Z, sum e gx, sum e gy) per joint, the
  // warps added in order
  float* part = partial + (long long)blockIdx.x * 4 * J;
  for (int u = tid; u < 4 * J; u += T) {
    if (u < J) {
      part[u] = mshared[u];
    } else {
      const int k = u / J - 1, j = u - (k + 1) * J;
      float a = red[0][k][j];
      for (int w = 1; w < kWarps; ++w) a += red[w][k][j];
      part[u] = a;
    }
  }
  // the block's stores, then one thread's fence and count (as a grid
  // barrier releases and acquires)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counters + p, 1u) == (unsigned)(S * G) - 1;
    if (last) {
      __threadfence();
      counters[p] = 0;                   // ready for the next call
    }
  }
  __syncthreads();
  if (!last) return;

  // the last of person p's blocks: the S x G partials into shared memory,
  // kBatch 16-byte loads of each thread in flight at once
  const int per_map = G * 4 * J, per4 = G * J, n4 = S * per4;
  const float4* src4 = reinterpret_cast<const float4*>(partial);
  for (int base = 0; base < n4; base += kBatch * T) {
    float4 r[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int u = base + k * T + tid, t = u / per4;
      if (u < n4) r[k] = __ldcg(src4 + (long long)(t * P + p) * per4 +
                                (u - t * per4));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int u = base + k * T + tid;
      if (u < n4) parts4[u] = r[k];
    }
  }
  __syncthreads();
  const float* parts = reinterpret_cast<const float*>(parts4);
  // map (t, p), joint j: its G partials rescaled to the map's max, added
  // in block order
  float* peak = reinterpret_cast<float*>(parts4) + S * per_map;  // (S, J)
  for (int u = tid; u < S * J; u += T) {
    const int t = u / J, j = u - t * J;
    const float* q = parts + t * per_map + j;
    float M = -INFINITY;
#pragma unroll 4
    for (int b = 0; b < G; ++b) M = fmaxf(M, q[b * 4 * J]);
    float Z = 0.f, EX = 0.f, EY = 0.f;
#pragma unroll 4
    for (int b = 0; b < G; ++b) {
      const float* qb = q + b * 4 * J;
      const float f = expf(__fsub_rn(qb[0], M));
      Z = fmaf(qb[J], f, Z);
      EX = fmaf(qb[2 * J], f, EX);
      EY = fmaf(qb[3 * J], f, EY);
    }
    const long long o = ((long long)(t * P + p) * J + j) * 2;
    coords[o] = EX / Z;
    coords[o + 1] = EY / Z;
    peak[u] = 1.f / Z;
  }
  __syncthreads();
  if (warp == 0) {                       // the mean of 1/Z: a fixed tree
    float t = 0.f;
    for (int u = lane; u < S * J; u += 32) t += peak[u];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) confs[p] = t / (float)(S * J);
  }
}

template <int J>
int launch(const float* planes, const float* grid, float* partial,
           unsigned* counters, float* coords, float* confs, int S, int P,
           int N, int G, int smem, float beta, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soft_argmax_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  soft_argmax_kernel<J><<<S * P * G, kThreads, smem, stream>>>(
      planes, grid, partial, counters, coords, confs, S, P, N, G, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// planes (S, P, N, J) with N % 4 == 0 and a 16-byte aligned base; grid
// (S, N, 2); partial (S * P * G, 4, J) scratch; counters (P,) zero on
// entry (and left zero); coords (S, P, J, 2); confs (P,). J in {15, 17};
// S * P * G blocks of 128 threads, G = ceil(N / 512), each block 512
// rows of a map, with `smem` >= 4 * S * J * (4 G + 1) bytes of dynamic
// shared memory: ops/kernels/softargmax.py::softargmax_plan.
FVP_API int fvp_soft_argmax(const float* planes, const float* grid,
                            float* partial, unsigned* counters, float* coords,
                            float* confs, int S, int P, int N, int J, int G,
                            int smem, float beta, void* stream) {
  if (S <= 0 || P <= 0 || N <= 0 || N % 4 ||
      G != (N + 4 * kThreads - 1) / (4 * kThreads) ||
      (long long)smem < 4ll * S * J * (4ll * G + 1) || smem > 232448 ||
      (reinterpret_cast<uintptr_t>(planes) & 15) ||
      (reinterpret_cast<uintptr_t>(grid) & 15) || !(beta > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (J == 15) return launch<15>(planes, grid, partial, counters, coords,
                                 confs, S, P, N, G, smem, beta, st);
  if (J == 17) return launch<17>(planes, grid, partial, counters, coords,
                                 confs, S, P, N, G, smem, beta, st);
  return (int)cudaErrorInvalidValue;
}

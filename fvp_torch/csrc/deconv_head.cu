// deconv_stage: one stage of the backbone's deconv head,
// ConvTranspose2d(k=4, s=2, p=1) + folded BN affine + ReLU, NHWC, bf16 out.
//
// Replaces fvp_tpu/ops/pallas/deconv_head.py::deconv_stage_rows and
// ::deconv_stage_chunked (one kernel for all three stages: streaming Cin in
// chunks was a VMEM workaround of the TPU). Output y[oy, ox] has parity
// r = (oy+1) % 2, source row i' = (oy+1) / 2 (likewise s, j' for x), and is
//   sum_{u,v in {0,1}} x[i'+u-1, j'+v-1, :] . W[2r+s][2u+v]   (zero outside)
// so each parity class is a GEMM (V*H*W) x (4*Cin) by (4*Cin) x F whose A
// rows gather four neighbours of one input pixel. With hi = i' - (1-r), the
// source row is hi + u - r and the output row 2*hi + 1 - r: the SAME crop
// of the TPU kernel's padded grid is folded into the indexing, and the
// kernel writes the interleaved (V, 2H, 2W, F) map directly.
//
// Numerics: x (float32 for the first stage, bf16 after) rounds to bf16 on
// load, weights are bf16, products sum in float32 on the tensor cores
// (wmma 16x16x16 bf16 fragments), the affine and ReLU apply to the
// float32 sum, and the result rounds to bf16 - the TPU kernel's numerics.
//
// Bound on the H100: operations. The head does 1.41e11 per 5-view frame
// (8.05e9, 4.03e9 and 1.61e10 per view for the three stages) against
// ~60 MB of traffic. Design: a 128 x 128 output tile per block of 8 warps
// (each 32 x 64, 2 x 4 accumulator fragments), K in steps of 32 staged in
// shared memory with the next step's loads held in registers while the
// current one multiplies (double-buffered shared memory, one barrier per
// step). Each thread loads the same A row throughout, so its four tap
// offsets and their validity are computed once. No wgmma, TMA or
// warp specialisation yet.

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;
constexpr int AS = BK + 8;    // shared row strides (bf16), 32-byte aligned rows
constexpr int BS = BN + 8;
constexpr int kAElems = BM * AS, kBElems = BK * BS;
constexpr int kSmemBytes = 2 * (kAElems + kBElems) * 2;

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 consecutive inputs of one A row as 16 bf16 (two uint4), zero if !ok
template <typename T>
__device__ __forceinline__ void load_a(const T* p, bool ok, uint4 (&r)[2]);

template <>
__device__ __forceinline__ void load_a<float>(const float* p, bool ok,
                                              uint4 (&r)[2]) {
  if (!ok) {
    r[0] = r[1] = make_uint4(0, 0, 0, 0);
    return;
  }
  const float4* q = reinterpret_cast<const float4*>(p);
  float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
  r[0] = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
  r[1] = make_uint4(pack2(c.x, c.y), pack2(c.z, c.w), pack2(d.x, d.y),
                    pack2(d.z, d.w));
}

template <>
__device__ __forceinline__ void load_a<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      bool ok, uint4 (&r)[2]) {
  if (!ok) {
    r[0] = r[1] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* q = reinterpret_cast<const uint4*>(p);
  r[0] = __ldg(q);
  r[1] = __ldg(q + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deconv_stage_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ aff,
                    __nv_bfloat16* __restrict__ y, int V, int H, int W,
                    int Cin, int F) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * kAElems;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.z, r = p >> 1, s = p & 1;
  const int M = V * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = 4 * Cin, KT = K / BK;
  const __nv_bfloat16* wp = w + (long long)p * K * F;

  // this thread's A row (fixed for the whole K loop) and its four taps
  const int arow = tid >> 1, acol = (tid & 1) * 16;
  long long tap_off[4];
  bool tap_ok[4];
  {
    const int m = m0 + arow;
    const bool in = m < M;
    const int mm = in ? m : 0;
    const int vw = mm / (H * W), rem = mm % (H * W);
    const int hi = rem / W, wi = rem % W;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int yy = hi + (t >> 1) - r, xx = wi + (t & 1) - s;
      tap_ok[t] = in && yy >= 0 && yy < H && xx >= 0 && xx < W;
      tap_off[t] = (((long long)vw * H + yy) * W + xx) * Cin + acol;
    }
  }
  // this thread's B piece: one k row, 16 columns
  const int brow = tid >> 3, bcol = (tid & 7) * 16;

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * BK, t = k0 / Cin, ci = k0 % Cin;
    // selects, not a dynamic index: keeps the taps in registers
    const long long off = t == 0 ? tap_off[0] : t == 1 ? tap_off[1]
                          : t == 2 ? tap_off[2] : tap_off[3];
    const bool ok = t == 0 ? tap_ok[0] : t == 1 ? tap_ok[1]
                    : t == 2 ? tap_ok[2] : tap_ok[3];
    load_a<T>(x + off + ci, ok, ra);
    const uint4* q = reinterpret_cast<const uint4*>(
        wp + (long long)(k0 + brow) * F + n0 + bcol);
    rb[0] = __ldg(q);
    rb[1] = __ldg(q + 1);
  };
  auto store = [&](int buf) {
    uint4* a = reinterpret_cast<uint4*>(As + buf * kAElems + arow * AS + acol);
    a[0] = ra[0];
    a[1] = ra[1];
    uint4* b = reinterpret_cast<uint4*>(Bs + buf * kBElems + brow * BS + bcol);
    b[0] = rb[0];
    b[1] = rb[1];
  };

  const int wm = warp & 3, wn = warp >> 2;       // warp tile 32 x 64
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    const __nv_bfloat16* a = As + buf * kAElems + (wm * 32) * AS;
    const __nv_bfloat16* b = Bs + buf * kBElems + wn * 64;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + i * 16 * AS + kk, AS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, b + kk * BS + j * 16, BS);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    if (kt + 1 < KT) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 fragment at a time in shared
  // memory (the operand buffers are free after the last barrier), applies
  // the affine and ReLU, and writes 8 bf16 (16 bytes) per lane
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + wm * 32 + i * 16 + er;
    long long obase = -1;
    if (m < M) {
      const int vw = m / (H * W), rem = m % (H * W);
      const int oy = 2 * (rem / W) + 1 - r, ox = 2 * (rem % W) + 1 - s;
      obase = (((long long)vw * 2 * H + oy) * 2 * W + ox) * F;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (obase >= 0) {
        const int f = n0 + wn * 64 + j * 16 + ec;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = fmaxf(stage[er * 16 + ec + e] * __ldg(aff + f + e) +
                           __ldg(aff + F + f + e),
                       0.f);
        *reinterpret_cast<uint4*>(y + obase + f) =
            make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                       pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x (V, H, W, Cin) float32 (x_bf16 == 0) or bf16; w (4 parities, 4 taps,
// Cin, F) bf16; aff (2, F) float32 (scale, shift); y (V, 2H, 2W, F) bf16.
// Cin % 32 == 0, F % 128 == 0.
FVP_API int fvp_deconv_stage(const void* x, const void* w, const float* aff,
                             void* y, int x_bf16, int V, int H, int W,
                             int Cin, int F, void* stream) {
  if (Cin % BK || F % BN || V <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int M = V * H * W;
  dim3 grid((M + BM - 1) / BM, F / BN, 4);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  if (x_bf16)
    deconv_stage_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wb, aff, yb, V, H, W, Cin, F);
  else
    deconv_stage_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), wb, aff, yb, V, H, W, Cin, F);
  return (int)cudaGetLastError();
}

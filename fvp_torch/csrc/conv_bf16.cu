// conv_bf16: a bf16 tensor-core implicit-GEMM conv on NHWC maps, with the
// affine, residual add, ReLU and store fused into its epilogue, and a bf16
// 2x2 max pool. P2PNet (ops/kernels/hourglass.py) and the bottleneck stage
// (ops/kernels/trunk.py) run on these two kernels.
//
// Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_p2pnet and
// fvp_tpu/ops/pallas/trunk.py::pallas_bottleneck_stage. Both TPU kernels
// keep a whole net (or stage) in VMEM and run it in one launch; on Hopper
// one 64 x 64 x 32 bf16 activation of P2PNet is already more than a block's
// 227 KB of shared memory, so the port runs them layer by layer, one launch
// per conv, and the activations pass through L2 and device memory.
//
// Bound on the H100: operations. P2PNet does 3.7e10 per frame (30 plane
// stacks of 64 x 64) and layer1 6.5e10 at 5 x 128 x 240, against tens of MB
// of traffic. Design, as csrc/deconv_head.cu: a 128 x BN output tile per
// block of 8 warps (wmma 16 x 16 x 16 bf16 fragments, float32
// accumulators), BN = 16..128 picked for the layer's width, K in steps of
// 32 staged in double-buffered shared memory with the next step's loads
// held in registers. A row of the GEMM is one output pixel; its K index
// is (tap, input channel), so each 16-wide chunk of an A row is one tap's
// 16 channels (a 32-byte load) when Cin % 16 == 0, and a gather of single
// values otherwise (the 7x7 front of P2PNet, Cin = 15, float32 input
// rounded to bf16 as it is read). Zero padding (SAME) and the ragged ends
// of M, K and N are masked in the loaders. The 2x2 stride-2 up-conv is the
// same GEMM with K = Cin and N = 4 F (the four parities' matrices side by
// side) and an epilogue that writes the interleaved map. No wgmma, TMA or
// warp specialisation yet.
//
// Numerics (the TPU kernels'): bf16 operands, float32 sums, the affine on
// the float32 sum, then the residual (bf16 or float32) added in float32,
// ReLU, and one rounding to the output type. An up-conv rounds
// relu(aff(sum)) to bf16, adds the bf16 skip in float32 and rounds again.

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BK = 32, kThreads = 256;
constexpr int AS = BK + 8;  // shared row stride of A (bf16): 80-byte rows

struct Args {
  const void* x;
  const bf16* w;
  const float* aff;
  const void* res;
  void* y;
  int x_bf16, res_kind, y_f32, N, H, W, Cin, F, k, mode, relu;
  int M, K, Ncols;  // GEMM: M output pixels (input pixels for an up-conv)
};

template <int BN>
struct Tile {
  static constexpr int WN = BN >= 32 ? 2 : 1;  // warps across N
  static constexpr int WM = 8 / WN;
  static constexpr int FM = BM / WM / 16;      // fragments per warp
  static constexpr int FN = BN / WN / 16;
  static constexpr int BS = BN + 8;            // shared row stride of B
  static constexpr int AE = BM * AS, BE = BK * BS;
  static constexpr int kSmem = 2 * (AE + BE) * 2;
};

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_f(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename TIn, int BN>
__global__ void __launch_bounds__(kThreads) conv_bf16_kernel(Args a) {
  using T = Tile<BN>;
  __shared__ __align__(128) unsigned char smem[T::kSmem];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * T::AE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (a.K + BK - 1) / BK;
  const int pad = a.k / 2;
  const TIn* x = static_cast<const TIn*>(a.x);
  // 16-element chunks of an A row are one tap's channels, 32-byte aligned
  const bool a_vec = a.x_bf16 && a.Cin % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  // 16-column chunks of B lie in one (parity) matrix, 32-byte aligned
  const bool b_vec = a.F % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;

  // this thread's A row (fixed for the whole K loop)
  const int arow = tid >> 1, acol = (tid & 1) * 16;
  const int am = m0 + arow;
  const bool a_in = am < a.M;
  int ab = 0, ah = 0, aw = 0;
  if (a_in) {
    ab = am / (a.H * a.W);
    const int rem = am - ab * a.H * a.W;
    ah = rem / a.W;
    aw = rem - ah * a.W;
  }
  // this thread's B piece: one k row, 16 columns (if it loads B at all)
  constexpr int kBLoaders = BK * BN / 16;
  const int brow = tid / (BN / 16), bcol = (tid % (BN / 16)) * 16;

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    // A: 16 consecutive K indices of row am
    if (a_vec) {
      const int kk = k0 + acol;
      bool ok = a_in && kk < a.K;
      long long off = 0;
      if (ok) {
        const int tap = kk / a.Cin, ci = kk - tap * a.Cin;
        const int ty = tap / a.k, tx = tap - ty * a.k;
        const int hh = ah + ty - pad, ww = aw + tx - pad;
        ok = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
        off = (((long long)ab * a.H + hh) * a.W + ww) * a.Cin + ci;
      }
      if (ok) {
        const uint4* q = reinterpret_cast<const uint4*>(
            reinterpret_cast<const bf16*>(x) + off);
        ra[0] = __ldg(q);
        ra[1] = __ldg(q + 1);
      } else {
        ra[0] = ra[1] = make_uint4(0, 0, 0, 0);
      }
    } else {
      // one division for the chunk's first (tap, channel), then a step
      float v[16];
      const int kk = k0 + acol;
      int tap = kk / a.Cin, ci = kk - tap * a.Cin;
      int ty = tap / a.k, tx = tap - ty * a.k;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        v[e] = 0.f;
        const int hh = ah + ty - pad, ww = aw + tx - pad;
        if (a_in && kk + e < a.K && hh >= 0 && hh < a.H && ww >= 0 &&
            ww < a.W)
          v[e] = load_f(x, (((long long)ab * a.H + hh) * a.W + ww) * a.Cin +
                               ci);
        if (++ci == a.Cin) {
          ci = 0;
          if (++tx == a.k) {
            tx = 0;
            ++ty;
          }
        }
      }
      ra[0] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                         pack2(v[4], v[5]), pack2(v[6], v[7]));
      ra[1] = make_uint4(pack2(v[8], v[9]), pack2(v[10], v[11]),
                         pack2(v[12], v[13]), pack2(v[14], v[15]));
    }
    // B: row k0 + brow, columns n0 + bcol .. + 15; column n is matrix
    // n / F (a parity of an up-conv, 0 for a conv), channel n % F
    if (tid < kBLoaders) {
      const int kk = k0 + brow, n = n0 + bcol;
      if (b_vec) {
        if (kk < a.K && n < a.Ncols) {
          const int p = n / a.F, f = n - p * a.F;
          const uint4* q = reinterpret_cast<const uint4*>(
              a.w + ((long long)p * a.K + kk) * a.F + f);
          rb[0] = __ldg(q);
          rb[1] = __ldg(q + 1);
        } else {
          rb[0] = rb[1] = make_uint4(0, 0, 0, 0);
        }
      } else {
        float v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int ne = n + e;
          v[e] = 0.f;
          if (kk < a.K && ne < a.Ncols) {
            const int p = ne / a.F, f = ne - p * a.F;
            v[e] = __bfloat162float(a.w[((long long)p * a.K + kk) * a.F + f]);
          }
        }
        rb[0] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                           pack2(v[4], v[5]), pack2(v[6], v[7]));
        rb[1] = make_uint4(pack2(v[8], v[9]), pack2(v[10], v[11]),
                           pack2(v[12], v[13]), pack2(v[14], v[15]));
      }
    }
  };
  auto store = [&](int buf) {
    uint4* ap = reinterpret_cast<uint4*>(As + buf * T::AE + arow * AS + acol);
    ap[0] = ra[0];
    ap[1] = ra[1];
    if (tid < kBLoaders) {
      uint4* bp =
          reinterpret_cast<uint4*>(Bs + buf * T::BE + brow * T::BS + bcol);
      bp[0] = rb[0];
      bp[1] = rb[1];
    }
  };

  const int wm = warp % T::WM, wn = warp / T::WM;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    const bf16* ab_ = As + buf * T::AE + (wm * T::FM * 16) * AS;
    const bf16* bb_ = Bs + buf * T::BE + wn * T::FN * 16;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], ab_ + i * 16 * AS + kk, AS);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        wmma::load_matrix_sync(fb, bb_ + kk * T::BS + j * 16, T::BS);
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    if (kt + 1 < KT) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 fragment at a time in shared
  // memory (free after the last barrier); a lane takes 8 columns of a row
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
  const bool up = a.mode == 1;
  // 8 consecutive columns are 8 consecutive channels of one output pixel
  const bool vec8 = a.F % 8 == 0;
  const bf16* res_b = static_cast<const bf16*>(a.res);
  const float* res_f = static_cast<const float*>(a.res);
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
    const int m = m0 + (wm * T::FM + i) * 16 + er;
    int b = 0, hi = 0, wi = 0;
    if (m < a.M) {
      b = m / (a.H * a.W);
      const int rem = m - b * a.H * a.W;
      hi = rem / a.W;
      wi = rem - hi * a.W;
    }
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int n = n0 + (wn * T::FN + j) * 16 + ec;
      if (m < a.M && n < a.Ncols) {
        float v[8];
        long long off[8];
        bool ok[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ne = n + e;
          ok[e] = ne < a.Ncols;
          const int p = up ? ne / a.F : 0, f = ne - p * a.F;
          off[e] = up ? (((long long)b * 2 * a.H + 2 * hi + (p >> 1)) * 2 *
                             a.W + 2 * wi + (p & 1)) * a.F + f
                      : (long long)m * a.F + f;
          float s = 0.f;
          if (ok[e]) {
            s = stage[er * 16 + ec + e] * __ldg(a.aff + f) +
                __ldg(a.aff + a.F + f);
            if (up) {
              s = round_bf16(fmaxf(s, 0.f));
              s += __bfloat162float(res_b[off[e]]);
            } else {
              if (a.res_kind == 1) s += __bfloat162float(res_b[off[e]]);
              if (a.res_kind == 2) s += __ldg(res_f + off[e]);
              if (a.relu) s = fmaxf(s, 0.f);
            }
          }
          v[e] = s;
        }
        if (a.y_f32) {
          float* y = static_cast<float*>(a.y);
          if (vec8 && ok[7]) {
            reinterpret_cast<float4*>(y + off[0])[0] =
                make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(y + off[0])[1] =
                make_float4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (ok[e]) y[off[e]] = v[e];
          }
        } else {
          bf16* y = static_cast<bf16*>(a.y);
          if (vec8 && ok[7]) {
            *reinterpret_cast<uint4*>(y + off[0]) =
                make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                           pack2(v[4], v[5]), pack2(v[6], v[7]));
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (ok[e]) y[off[e]] = __float2bfloat16_rn(v[e]);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <typename TIn>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int bn = a.Ncols <= 16 ? 16 : a.Ncols <= 32 ? 32
                 : a.Ncols <= 64 ? 64 : 128;
  dim3 grid((a.M + BM - 1) / BM, (a.Ncols + bn - 1) / bn);
  switch (bn) {
    case 16: conv_bf16_kernel<TIn, 16><<<grid, kThreads, 0, st>>>(a); break;
    case 32: conv_bf16_kernel<TIn, 32><<<grid, kThreads, 0, st>>>(a); break;
    case 64: conv_bf16_kernel<TIn, 64><<<grid, kThreads, 0, st>>>(a); break;
    default: conv_bf16_kernel<TIn, 128><<<grid, kThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

__global__ void maxpool2_bf16_kernel(const bf16* __restrict__ x,
                                     bf16* __restrict__ y, int N, int H,
                                     int W, int C) {
  const int Ho = H / 2, Wo = W / 2;
  const long long total = (long long)N * Ho * Wo * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long p = i / C;
    const int wo = (int)(p % Wo), ho = (int)((p / Wo) % Ho);
    const long long n = p / ((long long)Wo * Ho);
    const long long base = ((n * H + 2 * ho) * W + 2 * wo) * C + c;
    const float v = fmaxf(
        fmaxf(__bfloat162float(x[base]), __bfloat162float(x[base + C])),
        fmaxf(__bfloat162float(x[base + (long long)W * C]),
              __bfloat162float(x[base + (long long)W * C + C])));
    y[i] = __float2bfloat16_rn(v);  // exact: v is one of the bf16 inputs
  }
}

}  // namespace

// x (N, H, W, Cin) float32 (x_bf16 == 0) or bf16; w bf16: (k*k, Cin, F)
// for a conv (mode 0), (2, 2, Cin, F) for an up-conv (mode 1, k == 1);
// aff (2, F) float32; res: none (res_kind 0), bf16 (1) or float32 (2),
// shaped like y; y: (N, H, W, F) for a conv, (N, 2H, 2W, F) bf16 for an
// up-conv, bf16 or float32 (y_f32). An up-conv takes a bf16 skip in res and
// always applies ReLU before the skip add.
FVP_API int fvp_conv_bf16(const void* x, int x_bf16, const void* w,
                          const float* aff, const void* res, int res_kind,
                          void* y, int y_f32, int N, int H, int W, int Cin,
                          int F, int k, int mode, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || F <= 0 || k <= 0 ||
      k % 2 == 0 || (mode == 1 && (k != 1 || res_kind != 1 || y_f32)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = static_cast<const bf16*>(w);
  a.aff = aff;
  a.res = res;
  a.y = y;
  a.x_bf16 = x_bf16;
  a.res_kind = res_kind;
  a.y_f32 = y_f32;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.F = F;
  a.k = k;
  a.mode = mode;
  a.relu = relu;
  a.M = N * H * W;
  a.K = k * k * Cin;
  a.Ncols = mode == 1 ? 4 * F : F;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(x_bf16 ? launch<bf16>(a, st) : launch<float>(a, st));
}

// x (N, H, W, C) bf16 -> y (N, H/2, W/2, C) bf16, H and W even.
FVP_API int fvp_maxpool2_bf16(const void* x, void* y, int N, int H, int W,
                              int C, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * (H / 2) * (W / 2) * C;
  const int blocks = (int)((total + 255) / 256 < 65535 ? (total + 255) / 256
                                                       : 65535);
  maxpool2_bf16_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), N, H, W, C);
  return (int)cudaGetLastError();
}

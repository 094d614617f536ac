// conv_bf16: bf16 tensor-core implicit-GEMM convs on NHWC maps, with the
// affine, residual add, ReLU and store fused into their epilogues, and a
// bf16 2x2 max pool. P2PNet (ops/kernels/hourglass.py) and the bottleneck
// stage (ops/kernels/trunk.py) run on these kernels.
//
// Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_p2pnet and
// fvp_tpu/ops/pallas/trunk.py::pallas_bottleneck_stage. Both TPU kernels
// keep a whole net (or stage) in VMEM and run it in one launch; on Hopper
// one 64 x 64 x 32 bf16 activation of P2PNet is already more than a block's
// 227 KB of shared memory, so the port runs them layer by layer, one launch
// per conv, and the activations pass through L2 and device memory.
//
// Bound on the H100: operations at the tensor-core peak (P2PNet does
// 3.7e10 per frame, layer1 6.5e10 at 5 x 128 x 240), but layer by layer
// the maps' bytes set the floor: layer1's 10 launches move ~0.98 GB
// (~0.29 ms at 3.35 TB/s, less what L2 keeps), and P2PNet's small levels
// are a few microseconds of work per launch. A row of the GEMM is one output
// pixel (an input pixel of an up-conv), its K index (tap, input channel),
// N the output channels (4 F for an up-conv: the four parities' matrices
// side by side). Two kernels, chosen by shape (ops/kernels/conv_bf16.py::
// conv_plan):
//
// conv_wgmma_kernel, every conv whose input is bf16 with Cin 16, 32 or a
// multiple of 64 and whose N is 16..256 (a power of two): the deconv head's
// template (csrc/deconv_head.cu).
// - M tile: a th x tw patch (th * tw = 128, tw a power of two) of one
//   image; one N tile of all N columns, so A is read once; K in blocks of
//   one column dx of the taps by bk = min(Cin, 64) channels (32 where two
//   ring stages of 64 do not fit).
// - A by TMA: a 4D tensor map over x (Cin, W, H, N) with a (bk, tw, th +
//   k - 1, 1) box and a 2*bk-byte swizzle (32, 64 or 128 bytes), loaded at
//   (c0, w0 + dx - k/2, h0 - k/2): TMA's zero fill outside x is the SAME
//   padding, and tap (dy, dx) is the box's rows from dy * tw on (a whole
//   number of swizzle atoms). So a 3x3 conv loads 3 boxes of th + 2 rows
//   per channel block, not 9 of th rows: TMA's cost goes by box rows. A 1x1
//   conv and an up-conv are the one-tap case.
// - B by TMA from the packed (k*k, Cin, F) or (2, 2, Cin, F) weights as a
//   2D map, read MN-major (F contiguous) through wgmma's transpose bit: per
//   tap of the column, N / bw boxes of bw = min(F, 64) columns by bk rows,
//   2*bw-byte swizzle.
// - An mbarrier ring of up to 8 stages (as many as shared memory holds
//   beside the staged output tile), one producer thread, two consumer
//   warpgroups (64 rows each) issuing wgmma m64nNk16 with one group in
//   flight; one persistent CTA per SM walks the M tiles.
// - Epilogue in two passes per warpgroup. (A) The affine (staged in shared
//   memory once per CTA) of the accumulators into the staged tile: float32
//   in two column halves where a residual or a float32 output follows, else
//   bf16 with ReLU (an up-conv: bf16(ReLU(affine))). (B) The staged rows
//   leave in 16-byte pieces, neighbouring threads on neighbouring pieces:
//   the residual (or an up-conv's skip) read in 16-byte loads, two pieces
//   per thread in flight, after one thread per patch row has asked L2 for
//   the warpgroup's residual rows at the start of pass A; added in
//   float32, ReLU, one rounding; rows outside the map are skipped. Pass A
//   holds no global access and no branch on the data, pass B no unrolling
//   over the columns: the epilogue's instructions, not its bytes, were what
//   held a single-pass design (the residual read in the accumulator
//   layout) back on layer1's 256-wide convs.
//
// conv_bf16_kernel, the rest (P2PNet's 7x7 front: float32 input, Cin = 15;
// its 1x1 output layer: F = 15, whose 30-byte weight rows no TMA box
// takes): a 128 x BN output tile per block of 8 warps (wmma 16 x 16 x 16
// bf16 fragments, float32 accumulators), BN = 16..128 picked for the
// layer's width, K in steps of 32 staged in double-buffered shared memory
// with the next step's loads held in registers; each 16-wide chunk of an A
// row is one tap's 16 channels (a 32-byte load) when Cin % 16 == 0, and a
// gather of single values otherwise (float32 input rounded to bf16 as it is
// read). Zero padding (SAME) and the ragged ends of M, K and N are masked in
// the loaders.
//
// Numerics (the TPU kernels'): bf16 operands, float32 sums, the affine on
// the float32 sum, then the residual (bf16 or float32) added in float32,
// ReLU, and one rounding to the output type. An up-conv rounds
// relu(aff(sum)) to bf16, adds the bf16 skip in float32 and rounds again.

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;
using namespace fvp;
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

// ---- conv_wgmma_kernel -------------------------------------------------------

constexpr int kWM = 128;                        // rows of an M tile
constexpr int kWConsumers = 256;                // two warpgroups
constexpr int kWThreads = kWConsumers + 128;    // + the producer warpgroup
constexpr int kMaxSmem = 232448;

struct WArgs {
  const float* aff;   // (2, F)
  const void* res;    // none, bf16 or float32, shaped like y
  void* y;
  int res_kind, y_f32, relu, up;
  int N, H, W, Cin, F, k;
  int th, tw, tiles_h, tiles_w, mtiles;
  // ring stage: the A box (a_box bytes, a_bytes with its 1 KB rounding),
  // then the B boxes of the k taps of one column dx
  int bk, bw, kb_per_tap, kblocks, stages, a_box, a_bytes, stage_bytes;
};

// bytes of shared memory past the ring: the staged output tile (rows of
// 2 N + 16 bytes: conflict-free writes), the affine per column, mbarriers
__host__ __device__ constexpr int out_stride(int bn) { return 2 * bn + 16; }
__host__ __device__ constexpr int tail_bytes(int bn, int stages) {
  return kWM * out_stride(bn) + 2 * bn * 4 + 2 * stages * 8;
}

__device__ __forceinline__ void unpack8(uint4 t, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// The epilogue's first pass for column half C of a float32-staged tile:
// the affine of this thread's accumulators (rows lrow, lrow + 8 of its
// warpgroup, columns 8 j + 2 q, + 1) into the staged rows.
template <int BN, int C>
__device__ __forceinline__ void stage_f32(const float (&d)[BN / 2],
                                          const float* aff_s,
                                          unsigned char* rows, int stride,
                                          int lrow, int q) {
#pragma unroll
  for (int j = C * BN / 16; j < (C + 1) * BN / 16; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 sc = *reinterpret_cast<const float2*>(aff_s + col);
    const float2 sh = *reinterpret_cast<const float2*>(aff_s + BN + col);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(rows + (lrow + 8 * h) * stride +
                                 4 * (col - C * BN / 2)) =
          make_float2(d[4 * j + 2 * h] * sc.x + sh.x,
                      d[4 * j + 2 * h + 1] * sc.y + sh.y);
  }
}

// Where a tile's rows go: the element offset of its first pixel's first
// output channel (an up-conv: of its parity-0 output pixel), the rows and
// columns of the patch inside the map, and the offset steps of a patch row
// and column.
struct TileOut {
  long long base;
  int hin, win, hstep, wstep;
};

__device__ __forceinline__ TileOut tile_out(const WArgs& a, int img, int h0,
                                            int w0) {
  TileOut t;
  if (a.up) {
    t.base = (((long long)img * 2 * a.H + 2 * h0) * 2 * a.W + 2 * w0) * a.F;
    t.hstep = 4 * a.W * a.F;
    t.wstep = 2 * a.F;
  } else {
    t.base = (((long long)img * a.H + h0) * a.W + w0) * a.F;
    t.hstep = a.W * a.F;
    t.wstep = a.F;
  }
  t.hin = a.H - h0;
  t.win = a.W - w0;
  return t;
}

// The epilogue's second pass: rows row0 .. row0 + 63 of the staged tile
// (`ncol` columns from column `col0`, float32 where `stf`, else bf16, rows
// `stride` bytes apart) leave in 16-byte pieces. A thread keeps one piece
// of the columns and walks the rows, its neighbours on the neighbouring
// pieces. Each piece: the residual (bf16 or float32; an up-conv's skip)
// added in float32, ReLU, one rounding to the output type. Two rows at a
// time, their residual loads issued together; rows outside the map are
// skipped. Patch widths are powers of two (ltw = log2 tw).
__device__ __forceinline__ void write_rows(const WArgs& a, const TileOut& t,
                                           const unsigned char* rows,
                                           int stride, int ncol, int col0,
                                           bool stf, int wtid, int row0,
                                           int ltw) {
  constexpr int U = 2;
  const int vpc = a.y_f32 ? 4 : 8;                  // values per piece
  const int lcpr = __ffs(ncol / vpc) - 1;           // log2 pieces per row
  if ((wtid >> lcpr) >= 64) return;
  const int k = wtid & ((1 << lcpr) - 1), rstep = 128 >> lcpr;
  const int col = col0 + k * vpc;
  int coff = col;                         // the piece's offset in a row
  if (a.up) {
    const int p = col / a.F;
    coff = ((p >> 1) * 2 * a.W + (p & 1)) * a.F + col - p * a.F;
  }
  const unsigned char* src = rows + k * vpc * (stf ? 4 : 2);
  const __nv_bfloat16* res_b = static_cast<const __nv_bfloat16*>(a.res);
  const float* res_f = static_cast<const float*>(a.res);
  for (int r0 = wtid >> lcpr; r0 < 64; r0 += U * rstep) {
    long long o[U];
    float r[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int lr = r0 + u * rstep, row = row0 + lr;
      const int hl = row >> ltw, wl = row & ((1 << ltw) - 1);
      o[u] = lr < 64 && hl < t.hin && wl < t.win
                 ? t.base + (long long)hl * t.hstep + wl * t.wstep + coff
                 : -1;
      if (o[u] < 0 || a.res_kind == 0) continue;
      if (a.res_kind == 1) {
        if (vpc == 8) {
          unpack8(__ldg(reinterpret_cast<const uint4*>(res_b + o[u])), r[u]);
        } else {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(res_b + o[u]));
          unpack8(make_uint4(q.x, q.y, 0u, 0u), r[u]);
        }
      } else {
        const float4 q0 = __ldg(reinterpret_cast<const float4*>(res_f + o[u]));
        r[u][0] = q0.x, r[u][1] = q0.y, r[u][2] = q0.z, r[u][3] = q0.w;
        if (vpc == 8) {
          const float4 q1 =
              __ldg(reinterpret_cast<const float4*>(res_f + o[u] + 4));
          r[u][4] = q1.x, r[u][5] = q1.y, r[u][6] = q1.z, r[u][7] = q1.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (o[u] < 0) continue;
      float v[8];
      const unsigned char* s = src + (r0 + u * rstep) * stride;
      if (stf) {
        const float4 q0 = *reinterpret_cast<const float4*>(s);
        v[0] = q0.x, v[1] = q0.y, v[2] = q0.z, v[3] = q0.w;
        if (vpc == 8) {
          const float4 q1 = *reinterpret_cast<const float4*>(s + 16);
          v[4] = q1.x, v[5] = q1.y, v[6] = q1.z, v[7] = q1.w;
        }
      } else {
        unpack8(*reinterpret_cast<const uint4*>(s), v);
      }
      // a conv's staged values are the affine alone where it has a residual
      // or a float32 output (else ReLU and rounding are already applied);
      // an up-conv's are bf16(ReLU(affine)), and its skip is added here
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (a.res_kind) v[e] += r[u][e];
        if (stf && a.relu) v[e] = fmaxf(v[e], 0.f);
      }
      if (a.y_f32) {
        *reinterpret_cast<float4*>(static_cast<float*>(a.y) + o[u]) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) + o[u]) =
            make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                       pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kWThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w, const WArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  constexpr int kOut = out_stride(BN);
  unsigned char* staged = smem + a.stages * a.stage_bytes;
  float* aff_s = reinterpret_cast<float*>(staged + kWM * kOut);
  const uint32_t full0 = smem_u32(aff_s + 2 * BN);
  const uint32_t empty0 = full0 + 8 * a.stages;
  const int tid = threadIdx.x;
  const int per_img = a.tiles_h * a.tiles_w;

  if (tid < BN) {                 // column n is channel n % F (parity n / F)
    const int f = tid % a.F;
    aff_s[tid] = a.aff[f];
    aff_s[BN + tid] = a.aff[a.F + f];
  }
  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWConsumers) {
    // ---- producer: one thread keeps the ring full across the M tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == kWConsumers) {
      const int pad = a.k / 2, nbox = BN / a.bw;
      const uint32_t box = a.bk * a.bw * 2;
      int g = 0;                                  // ring position
      for (int mt = blockIdx.x; mt < a.mtiles; mt += gridDim.x) {
        const int img = mt / per_img, rem = mt - img * per_img;
        const int h0 = (rem / a.tiles_w) * a.th, w0 = (rem % a.tiles_w) * a.tw;
        for (int kb = 0; kb < a.kblocks; ++kb, ++g) {
          const int st = g % a.stages;
          if (g >= a.stages)
            mbar_wait(empty0 + 8 * st, ((g / a.stages) & 1) ^ 1);
          // k block kb: column dx of the taps, channels c0 .. c0 + bk; its
          // A box is the patch with k - 1 more rows, which the k taps dy of
          // the column read at row offsets dy * tw
          const int dx = kb / a.kb_per_tap;
          const int c0 = (kb - dx * a.kb_per_tap) * a.bk;
          const uint32_t full = full0 + 8 * st;
          const uint32_t sa = base + st * a.stage_bytes, sb = sa + a.a_bytes;
          mbar_expect_tx(full, a.a_box + a.k * nbox * box);
          tma_load_4d(sa, &tm_x, full, c0, w0 + dx - pad, h0 - pad, img);
          for (int dy = 0; dy < a.k; ++dy)
            for (int j = 0; j < nbox; ++j) {
              const int col = j * a.bw, p = col / a.F;  // an up-conv's parity
              tma_load_2d(sb + (dy * nbox + j) * box, &tm_w, full,
                          col - p * a.F,
                          (p * a.k * a.k + dy * a.k + dx) * a.Cin + c0);
            }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 wg .. 64 wg + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31, q = lane & 3;
    const int wtid = tid & 127;
    const uint32_t box = a.bk * a.bw * 2;
    const uint32_t sw_a = 2 * a.bk, sw_b = 2 * a.bw;
    const int ksteps = a.bk / 16;
    // staged as float32, in two column halves, where the residual or a
    // float32 output comes after the affine; else as bf16, whole
    const bool stf = a.y_f32 || (a.res_kind != 0 && !a.up);
    // this warpgroup's 64 staged rows, and its thread's two rows in them
    unsigned char* wst = staged + 64 * wg * kOut;
    const int lrow = 16 * (warp & 3) + (lane >> 2);
    const int ltw = __ffs(a.tw) - 1;
    int g = 0;
    for (int mt = blockIdx.x; mt < a.mtiles; mt += gridDim.x) {
      const int img = mt / per_img, rem = mt - img * per_img;
      const int h0 = (rem / a.tiles_w) * a.th, w0 = (rem % a.tiles_w) * a.tw;
      const TileOut tout = tile_out(a, img, h0, w0);
      float d[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

      for (int kb = 0; kb < a.kblocks; ++kb, ++g) {
        const int st = g % a.stages;
        mbar_wait(full0 + 8 * st, (g / a.stages) & 1);
        const uint32_t sa = base + st * a.stage_bytes + wg * (64 * 2 * a.bk);
        const uint32_t sb = base + st * a.stage_bytes + a.a_bytes;
        wgmma_fence();
        for (int dy = 0; dy < a.k; ++dy)
          for (int kk = 0; kk < ksteps; ++kk)
            // A: tap dy's rows start dy * tw rows in, +32 bytes per k16
            // inside the swizzled rows, SBO the next 8 rows; B: tap dy's
            // boxes, +16 rows per k16, SBO the next 8 rows, LBO the next box
            // of bw columns
            Wgmma<BN>::mma(
                d, smem_desc(sa + dy * a.tw * sw_a + 32 * kk, 16, 8 * sw_a,
                             sw_a),
                smem_desc(sb + dy * (BN / a.bw) * box + kk * 16 * sw_b, box,
                          8 * sw_b, sw_b));
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();             // the previous stage is read: free it
          if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % a.stages));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % a.stages));
      if (a.res_kind && wtid < 64 / a.tw) {
        // this warpgroup's residual rows into L2 while pass A runs: one
        // contiguous run of pixels per patch row (two output rows of an
        // up-conv's skip per input row)
        const int hl = (64 * wg) / a.tw + wtid;
        if (hl < tout.hin) {
          const int esz = a.res_kind == 2 ? 4 : 2;
          for (int py = 0; py <= a.up; ++py)
            prefetch_l2(static_cast<const unsigned char*>(a.res) +
                            (tout.base + (long long)hl * tout.hstep +
                             py * 2 * a.W * a.F) * esz,
                        min(a.tw, tout.win) * tout.wstep * esz);
        }
      }

      // ---- epilogue, each warpgroup on its own 64 rows: (A) the affine of
      // the accumulators into the staged rows (an up-conv's ReLU and bf16
      // rounding, a bf16 conv's without residual its ReLU and rounding too),
      // (B) the rows out in 16-byte pieces (write_rows) ----
      for (int c = 0; c < (stf ? 2 : 1); ++c) {
        named_sync(2 + wg, 128);         // pass B before has read the rows
        if (stf) {
          if (c == 0)
            stage_f32<BN, 0>(d, aff_s, wst, kOut, lrow, q);
          else
            stage_f32<BN, 1>(d, aff_s, wst, kOut, lrow, q);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = 8 * j + 2 * q;
            const float2 sc = *reinterpret_cast<const float2*>(aff_s + col);
            const float2 sh =
                *reinterpret_cast<const float2*>(aff_s + BN + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = d[4 * j + 2 * h] * sc.x + sh.x;
              float v1 = d[4 * j + 2 * h + 1] * sc.y + sh.y;
              if (a.up || a.relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              *reinterpret_cast<uint32_t*>(wst + (lrow + 8 * h) * kOut +
                                           2 * col) = pack2(v0, v1);
            }
          }
        }
        named_sync(2 + wg, 128);
        write_rows(a, tout, wst, kOut, stf ? BN / 2 : BN, c * BN / 2, stf,
                   wtid, 64 * wg, ltw);
      }
    }
  }
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                         const WArgs& a, int ctas, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int smem = 1024 + a.stages * a.stage_bytes + tail_bytes(BN, a.stages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  conv_wgmma_kernel<BN><<<ctas, kWThreads, smem, st>>>(tm_x, tm_w, a);
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

// The conv_wgmma route (the arguments as fvp_conv_bf16's, mode 0 or 1): x
// bf16, bk in {16, 32, 64} divides Cin; N = F (4 F for an up-conv) in {16,
// 32, 64, 128, 256}; bw in {16, 32, 64} divides F; th * tw == 128, tw a
// power of two; `stages` (2..8) ring stages; `ctas` persistent CTAs (at
// most one per M tile). The tiling comes from conv_plan (ops/kernels/
// conv_bf16.py). x, w, res and y 16-byte aligned.
FVP_API int fvp_conv_wgmma(const void* x, const void* w, const float* aff,
                           const void* res, int res_kind, void* y, int y_f32,
                           int N, int H, int W, int Cin, int F, int k,
                           int mode, int relu, int th, int tw, int bk, int bw,
                           int stages, int ctas, void* stream) {
  const int ncols = mode == 1 ? 4 * F : F;
  if (N <= 0 || H <= 0 || W <= 0 || k <= 0 || k % 2 == 0 ||
      (mode == 1 && (k != 1 || res_kind != 1 || y_f32)) ||
      (bk != 16 && bk != 32 && bk != 64) || Cin % bk ||
      (bw != 16 && bw != 32 && bw != 64) || F % bw || th * tw != kWM ||
      (tw & (tw - 1)) || th + k - 1 > 256 || stages < 2 || stages > 8 || ctas < 1 ||
      (ncols != 16 && ncols != 32 && ncols != 64 && ncols != 128 &&
       ncols != 256))
    return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = fvp::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  WArgs a;
  a.aff = aff;
  a.res = res;
  a.y = y;
  a.res_kind = res_kind;
  a.y_f32 = y_f32;
  a.relu = relu;
  a.up = mode == 1;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.F = F;
  a.k = k;
  a.th = th;
  a.tw = tw;
  a.tiles_h = (H + th - 1) / th;
  a.tiles_w = (W + tw - 1) / tw;
  a.mtiles = N * a.tiles_h * a.tiles_w;
  a.bk = bk;
  a.bw = bw;
  a.kb_per_tap = Cin / bk;
  a.kblocks = k * a.kb_per_tap;
  a.stages = stages;
  a.a_box = (th + k - 1) * tw * bk * 2;
  a.a_bytes = (a.a_box + 1023) / 1024 * 1024;
  a.stage_bytes = (a.a_bytes + k * bk * ncols * 2 + 1023) / 1024 * 1024;
  if (ctas > a.mtiles) return (int)cudaErrorInvalidValue;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t xstr[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                              (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, (cuuint32_t)tw,
                              (cuuint32_t)(th + k - 1),
                              1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  // zero fill outside x (FLOAT_OOB_FILL_NONE): the SAME padding
  if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             xdim, xstr, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             fvp::tma_swizzle(2 * bk), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)F,
                              (cuuint64_t)(mode == 1 ? 4 : k * k) * Cin};
  const cuuint64_t wstr[1] = {(cuuint64_t)F * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)bw, (cuuint32_t)bk};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             wdim, wstr, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             fvp::tma_swizzle(2 * bw), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (ncols) {
    case 16: e = launch_wgmma<16>(tm_x, tm_w, a, ctas, st); break;
    case 32: e = launch_wgmma<32>(tm_x, tm_w, a, ctas, st); break;
    case 64: e = launch_wgmma<64>(tm_x, tm_w, a, ctas, st); break;
    case 128: e = launch_wgmma<128>(tm_x, tm_w, a, ctas, st); break;
    default: e = launch_wgmma<256>(tm_x, tm_w, a, ctas, st); break;
  }
  return (int)e;
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

// K3's bf16 route: all of CenterNet in bf16 in one persistent, cooperative
// launch, on tensor cores.
//
// Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_centernet under
// compute_dtype='bfloat16' (_centernet_kernel: the hourglass body and the
// two heads in one launch, bf16 operands, float32 sums). It rounds where
// the TPU kernel rounds (_hourglass_body, _resblock, _upsample): the BEV
// to bf16 as it is staged; each ResBlock's first conv after its affine and
// ReLU; the join bf16(relu(h2 + skip)), a projection skip in float32 and
// an identity skip the bf16 input; each up-conv after its affine and
// ReLU, and again after its skip add; the merged 32 -> 64 heads conv after
// its bias and ReLU; the 64 -> 3 output sums in float32 and adds its
// float32 bias.
//
// Bound on the H100: operations, ~2.2 GFLOP at B = 1 on the flagship 80x80
// BEV (0.0022 ms at 989 TFLOP/s bf16); every tensor is under 1 MB and
// stays in L2. What held the route back before this kernel: 26 launches a
// call (the P2PNet lowering on csrc/conv_bf16.cu, 22 conv_wgmma + 2 wmma +
// 2 pools), each filling a few 128-row M tiles of a 6400-, 1600- or
// 400-pixel map on 132 SMs and draining (0.3152-0.4023 ms at B = 1,
// NVIDIA H100 80GB HBM3, 700 W), and 26 host enqueues on a host-bound
// frame. Design, after the float32 kernel (csrc/centernet.cu):
// - the host's plan (ops/kernels/centernet.py::centernet_bf16_plan)
//   schedules the net as the same 16 stages of ops and each op as output
//   tiles of th x 8 pixels x tn channels; one launch walks the stages with
//   a grid barrier between them (the grid no larger than what is
//   co-resident), each block taking the stage's tiles in turn;
// - fusions: the 2x2 max pool in the staging of the conv that reads it (a
//   max of bf16 values is exact); a ResBlock's 1x1 projection as extra K
//   chunks with their own accumulators and affine; the up-conv's skip add
//   and the heads' 1x1 convs in the epilogues;
// - the op and stage tables sit in shared memory, so a tile's fields cost
//   no round trip to L2 after a barrier;
// - a tile's input patch with its halo and the weights' K chunk are
//   staged in shared memory with cp.async: all input channels in one
//   chunk (one round trip to L2 a tile) where that fits the plan's 113 KB,
//   else chunks of 32, double-buffered, then the projection's in the
//   second buffer; the 7x7 front's J input channels are padded to 16 (one
//   k16 step per tap) as the BEV is rounded in; a block keeps the
//   weights it staged for its next tile of the same op and channel slice
//   where the op takes one chunk (at B = 8 most ops, ~6 tiles a block,
//   their weights 3-10x a tile's input patch), the heads' hidden tile
//   past them;
// - one block of 256 threads an SM (__launch_bounds__(256, 1)): at two
//   (128 registers) the accumulators spilled and the time did not move
//   (0.1778 against 0.1748 ms); loading the next stage's weights before
//   the grid barrier cost more than it hid (0.1932 against 0.1761 ms
//   without; fvp_torch/tools/kernel_parts.py, NVIDIA H100 80GB HBM3,
//   700 W);
// - mma.sync m16n8k16, bf16 operands and float32 sums, fed by ldmatrix:
//   a warp's M fragment is 2 rows x 8 columns of the tile (an up-conv's
//   the 16 output pixels of one parity, all reading the same 4 x 4 input
//   pixels), its N nf fragments of 8 channels; rows of staged pixels and
//   weights padded to an odd number of 16-byte units, so ldmatrix's 8
//   rows hit 8 bank quads;
// - each warp sums its whole K in a fixed order (a tap's k16 steps
//   unrolled on immediate shared-memory offsets, so their loads issue back
//   to back), with no atomics: two calls give the same bits;
// - intermediates (bf16, half the float32 kernel's arena) written by one
//   stage and read by a later one go through L2 (cp.async.cg,
//   ld.global.cg), never the non-coherent path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kOpW = 48;         // ints per op in the table
constexpr int kHidStride = 72;   // bf16 a pixel of the heads' hidden tile
constexpr int kMaxOps = 24;      // the op table held in shared memory
constexpr int kMaxStages = 20;

// one op of the table (ops/kernels/centernet.py::BF16_OP_FIELDS, same
// order)
enum Field {
  F_KIND, F_K, F_H, F_W, F_CIN, F_CINP, F_COUT,
  F_IN_SRC, F_IN_OFF, F_IN_POOL, F_W_OFF, F_AFF_OFF, F_RELU,
  F_RES_KIND, F_RES_OFF,
  F_P_IN_OFF, F_P_CIN, F_P_POOL, F_P_W_OFF, F_P_AFF_OFF,
  F_OUT_OFF, F_OUT2_OFF, F_O_W_OFF, F_O_AFF_OFF,
  F_TH, F_TW, F_TN, F_WM, F_WN, F_NF, F_CK, F_CKP,
  F_TILES_Y, F_TILES_X, F_TILES_C, F_TILES, F_XS, F_XSP, F_XF, F_WF,
};

enum Kind { CONV = 0, UPCONV = 1, HEADS = 2 };
enum Res { RES_NONE = 0, RES_ADD = 1, RES_PROJ = 2, RES_SKIP = 3 };

typedef __nv_bfloat16 bf16;

struct Ptrs {
  const float* bev;   // (B, H, W, J) float32
  const bf16* wts;    // every layer's (taps, Cout, Cin16) weights
  const float* aff;   // every layer's (scale, shift) rows
  bf16* arena;        // the intermediates
  float* out;         // hm (B, H, W), then size (B, H, W, 2)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// arena data: written by other blocks in an earlier stage of this launch,
// so read through L2 only
__device__ __forceinline__ uint4 ldcg16(const bf16* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t ldcg4(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned int*>(p));
}

// a / b for 0 <= a < 2^22 and b > 0, by b's float reciprocal (exact, as
// in csrc/centernet.cu): no integer division in the staging loops
__device__ __forceinline__ int div_small(int a, float inv_b) {
  return (int)(((float)a + 0.5f) * inv_b);
}

__device__ __forceinline__ uint32_t hmax2u(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 m = __hmax2(x, y);
  return *reinterpret_cast<uint32_t*>(&m);
}

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  return make_uint4(hmax2u(a.x, b.x), hmax2u(a.y, b.y), hmax2u(a.z, b.z),
                    hmax2u(a.w, b.w));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ldmatrix at a shared-memory byte address (volatile: it reads what
// cp.async and the block's stores wrote before the last barrier)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// registers only: the compiler may schedule it past the next loads
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage an input patch from the bf16 arena: PH x PW pixels of channels
// [ci0, ci0 + ck) at pixel stride XS, from the (Hin, Win, C) map (a
// pooled map: the max of each 2x2 window of the (2 Hin, 2 Win) source),
// zero outside the map. (oy, ox): the patch's first pixel. C % 8 == 0.
__device__ void stage_x(bf16* xs, const bf16* src, int n, int C, int Hin,
                        int Win, bool pool, int oy, int ox, int PH, int PW,
                        int ci0, int ck, int XS) {
  const int nv = ck >> 3;                          // 16-byte vectors a pixel
  const int total = PH * PW * nv;
  const float inv_nv = 1.f / (float)nv, inv_pw = 1.f / (float)PW;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = div_small(i, inv_nv), v = i - p * nv;
    const int py = div_small(p, inv_pw), px = p - py * PW;
    const int gy = oy + py, gx = ox + px, c = ci0 + 8 * v;
    bf16* dst = xs + p * XS + 8 * v;
    const bool inb = gy >= 0 && gy < Hin && gx >= 0 && gx < Win;
    if (pool) {
      uint4 m = make_uint4(0u, 0u, 0u, 0u);
      if (inb) {
        const long long row = (long long)2 * Win * C;
        const bf16* s0 =
            src + (((long long)n * 2 * Hin + 2 * gy) * (2 * Win) + 2 * gx) *
                      C + c;
        m = max8(max8(ldcg16(s0), ldcg16(s0 + C)),
                 max8(ldcg16(s0 + row), ldcg16(s0 + row + C)));
      }
      *reinterpret_cast<uint4*>(dst) = m;
    } else {
      cp_async16(dst,
                 inb ? src + (((long long)n * Hin + gy) * Win + gx) * C + c
                     : src,
                 inb);
    }
  }
}

// Stage the front's patch from the float32 BEV: PH x PW pixels of its
// channels [ci0, ci0 + ck) rounded to bf16, zero outside the map and from
// channel J on.
__device__ void stage_bev(bf16* xs, const float* bev, int n, int J, int H,
                          int W, int oy, int ox, int PH, int PW, int ci0,
                          int ck, int XS) {
  const int total = PH * PW * ck;
  const float inv_ck = 1.f / (float)ck, inv_pw = 1.f / (float)PW;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = div_small(i, inv_ck), c = i - p * ck;
    const int py = div_small(p, inv_pw), px = p - py * PW;
    const int gy = oy + py, gx = ox + px, cj = ci0 + c;
    float v = 0.f;
    if (cj < J && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(bev + (((long long)n * H + gy) * W + gx) * J + cj);
    xs[p * XS + c] = __float2bfloat16_rn(v);
  }
}

// Stage the weights of taps x output channels [c0, c0 + tn) x input
// channels [ci0, ci0 + ck) of a (taps, Cout, Cin16) layer: rows of ck at
// stride XS, one row per (tap, output channel).
__device__ void stage_w(bf16* ws, const bf16* w, int taps, int Cout,
                        int Cin16, int ci0, int ck, int c0, int tn, int XS) {
  const int nv = ck >> 3;
  const int total = taps * tn * nv;
  const float inv_nv = 1.f / (float)nv, inv_tn = 1.f / (float)tn;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = div_small(i, inv_nv), v = i - r * nv;
    const int tap = div_small(r, inv_tn), o = r - tap * tn;
    cp_async16(ws + r * XS + 8 * v,
               w + ((long long)(tap * Cout + c0 + o) * Cin16 + ci0 + 8 * v),
               true);
  }
}

// One K chunk: for each tap (dy, dx) of k x k and each of its ks = ck / 16
// k16 steps s, the warp's A fragment (its 16 pixels: the lane's ldmatrix
// row at byte address xa, the tap dy PW + dx pixels on, 32 s bytes in)
// and its NF B fragments (the tap's rows nb .. nb + 8 NF of tn, at byte
// address wb), summed into acc in that order. An up-conv passes k = 1 and
// its parity's tap in wb. Rows are XSb bytes apart. KS > 0: the tap's ks =
// KS steps unrolled on immediate offsets, so their loads issue back to
// back; KS = 0: any ks, in a loop.
template <int NF, int KS>
__device__ __forceinline__ void compute(float (&acc)[NF][4], uint32_t xa,
                                        uint32_t wb, int k, int ks, int XSb,
                                        int PW, int tap_bytes) {
  for (int dy = 0; dy < k; ++dy)
    for (int dx = 0; dx < k; ++dx) {
      const uint32_t xt = xa + (dy * PW + dx) * XSb;
      const uint32_t wt = wb + (dy * k + dx) * tap_bytes;
#pragma unroll
      for (int s = 0; s < (KS > 0 ? KS : ks); ++s) {
        {
          uint32_t a[4];
          ldsm_x4(a, xt + 32 * s);
          if constexpr (NF == 1) {
            uint32_t b[2];
            ldsm_x2(b, wt + 32 * s);
            mma_16816(acc[0], a, b[0], b[1]);
          } else {
#pragma unroll
            for (int j = 0; j < NF; j += 2) {
              uint32_t b[4];
              ldsm_x4(b, wt + 8 * j * XSb + 32 * s);
              mma_16816(acc[j], a, b[0], b[1]);
              mma_16816(acc[j + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
}

// compute<NF, KS> for the chunk's ks k16 steps a tap
template <int NF>
__device__ __forceinline__ void compute_ks(float (&acc)[NF][4], uint32_t xa,
                                           uint32_t wb, int k, int ks,
                                           int XSb, int PW, int tap_bytes) {
  switch (ks) {
    case 1: compute<NF, 1>(acc, xa, wb, k, ks, XSb, PW, tap_bytes); break;
    case 2: compute<NF, 2>(acc, xa, wb, k, ks, XSb, PW, tap_bytes); break;
    case 4: compute<NF, 4>(acc, xa, wb, k, ks, XSb, PW, tap_bytes); break;
    case 8: compute<NF, 8>(acc, xa, wb, k, ks, XSb, PW, tap_bytes); break;
    default: compute<NF, 0>(acc, xa, wb, k, ks, XSb, PW, tap_bytes); break;
  }
}

__device__ __forceinline__ float aff1(float a, float sc, float sh) {
  return __fadd_rn(__fmul_rn(a, sc), sh);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// tile t of an op: its image n, first row y0, column x0 and channel c0
// (the channel slice fastest, then columns, rows, batch)
__device__ __forceinline__ void tile_origin(const int* __restrict__ op,
                                            int t, int& n, int& y0, int& x0,
                                            int& c0) {
  const int tiles_c = op[F_TILES_C], tiles_x = op[F_TILES_X],
            tiles_y = op[F_TILES_Y];
  int r = t;
  const int tc = r % tiles_c;
  r /= tiles_c;
  const int tx = r % tiles_x;
  r /= tiles_x;
  const int ty = r % tiles_y;
  n = r / tiles_y;
  c0 = tc * op[F_TN];
  x0 = tx * op[F_TW];
  y0 = ty * op[F_TH];
}

// One output tile. w_held: the op takes one chunk and shared memory
// still holds the weights of this tile's channel slice (the block's last
// tile was of the same op and slice), so only its input patch is staged.
template <int NF>
__device__ void run_tile(const int* __restrict__ op, const Ptrs& P, int t,
                         bf16* smem, bool w_held) {
  const int kind = op[F_KIND], k = op[F_K];
  const int H = op[F_H], W = op[F_W], cinp = op[F_CINP], cout = op[F_COUT];
  const int th = op[F_TH], tw = op[F_TW], tn = op[F_TN], wn = op[F_WN];
  const int ck = op[F_CK], ckp = op[F_CKP], p_cin = op[F_P_CIN];
  const int XS = op[F_XS], XSP = op[F_XSP], xf = op[F_XF], wf = op[F_WF];
  const int res_kind = op[F_RES_KIND];

  int n, y0, x0, c0;
  tile_origin(op, t, n, y0, x0, c0);

  // the warp's part: M fragment mf, channel group ng of NF n8 fragments
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = wid % wn, mf = wid / wn;
  const int nb = ng * NF * 8;
  const int g = lane >> 2, tq = lane & 3;
  // the lane's ldmatrix rows: of the A fragment, fragment row lr and k
  // half kh (an element offset); of the B fragments, output channel b_row
  // of the tap's rows and its k half, kh too (lanes 8 apart alternate
  // k halves over the same 8 rows, x2 for NF = 1; x4 takes 16 rows)
  const int lr = lane & 15, kh = (lane >> 4) << 3;
  const int b_row =
      nb + (NF == 1 ? (lane & 7) : (lane & 7) + ((lane >> 4) << 3));
  const int kb = ((lane >> 3) & 1) << 3;
  const int pad = k >> 1;
  int a_off, ap_off;
  if (kind == UPCONV) {
    // row lr: input pixel (lr / 4, lr % 4) of the (th / 2) x (tw / 2)
    // patch
    a_off = ((lr >> 2) * (tw >> 1) + (lr & 3)) * XS + kh;
    ap_off = 0;
  } else {
    // row lr: tile pixel (2 mf + lr / 8, lr % 8)
    const int pr = 2 * mf + (lr >> 3), pc = lr & 7;
    a_off = (pr * (tw + k - 1) + pc) * XS + kh;
    ap_off = (pr * tw + pc) * XSP + kh;
  }

  const bf16* in = P.arena + op[F_IN_OFF];
  const bf16* pin = P.arena + op[F_P_IN_OFF];
  const bf16* w = P.wts + op[F_W_OFF];
  const bf16* pw = P.wts + op[F_P_W_OFF];
  const bool pool = op[F_IN_POOL] != 0, ppool = op[F_P_POOL] != 0;
  const int nch_main = cinp / ck;
  const int nch = nch_main + (p_cin ? p_cin / ckp : 0);

  auto stage = [&](int ch, int buf) {
    bf16* xs = smem + buf * (xf + wf);
    bf16* ws = xs + xf;
    if (ch < nch_main) {
      const int ci0 = ch * ck;
      if (kind == UPCONV) {
        stage_x(xs, in, n, op[F_CIN], H >> 1, W >> 1, false, y0 >> 1,
                x0 >> 1, th >> 1, tw >> 1, ci0, ck, XS);
        if (!w_held) stage_w(ws, w, 4, cout, cinp, ci0, ck, c0, tn, XS);
      } else {
        if (op[F_IN_SRC] == 0)
          stage_bev(xs, P.bev, n, op[F_CIN], H, W, y0 - pad, x0 - pad,
                    th + k - 1, tw + k - 1, ci0, ck, XS);
        else
          stage_x(xs, in, n, op[F_CIN], H, W, pool, y0 - pad, x0 - pad,
                  th + k - 1, tw + k - 1, ci0, ck, XS);
        if (!w_held) stage_w(ws, w, k * k, cout, cinp, ci0, ck, c0, tn, XS);
      }
    } else {
      const int ci0 = (ch - nch_main) * ckp;
      stage_x(xs, pin, n, p_cin, H, W, ppool, y0, x0, th, tw, ci0, ckp,
              XSP);
      stage_w(ws, pw, 1, cout, p_cin, ci0, ckp, c0, tn, XSP);
    }
  };

  float acc[NF][4], acc2[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc2[j][e] = 0.f;

  stage(0, 0);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1, (ch + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t xs = smem_addr(smem + (ch & 1) * (xf + wf));
    const uint32_t ws = xs + 2 * xf;
    if (ch >= nch_main)
      compute_ks<NF>(acc2, xs + 2 * ap_off, ws + 2 * (b_row * XSP + kb), 1,
                     ckp >> 4, 2 * XSP, tw, 0);
    else if (kind == UPCONV)
      compute_ks<NF>(acc, xs + 2 * a_off,
                     ws + 2 * ((mf * tn + b_row) * XS + kb), 1, ck >> 4,
                     2 * XS, tw >> 1, 0);
    else
      compute_ks<NF>(acc, xs + 2 * a_off, ws + 2 * (b_row * XS + kb), k,
                     ck >> 4, 2 * XS, tw + k - 1, 2 * tn * XS);
    __syncthreads();
  }

  // the epilogue: fragment rows g (e = 0) and g + 8 (e = 1), channels
  // c0 + nb + 8 j + 2 tq and + 1
  const float* aff = P.aff + op[F_AFF_OFF];
  const float* paff = P.aff + op[F_P_AFF_OFF];
  const bool relu = op[F_RELU] != 0;
  bf16* out = P.arena + op[F_OUT_OFF];
  const bf16* res = P.arena + op[F_RES_OFF];
  bf16* hid = smem + xf + wf;         // the heads' hidden tile, past
                                      // the first buffer's weights
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    int py, px;                       // the pixel in the tile
    if (kind == UPCONV) {
      const int q = g + 8 * e;
      py = 2 * (q >> 2) + (mf >> 1);
      px = 2 * (q & 3) + (mf & 1);
    } else {
      py = 2 * mf + e;
      px = g;
    }
    const int y = y0 + py, x = x0 + px;
    const bool inside = y < H && x < W;
    const long long pix = ((long long)n * H + y) * W + x;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int cl = nb + 8 * j + 2 * tq, co = c0 + cl;
      float v0 = aff1(acc[j][2 * e], __ldg(aff + co), __ldg(aff + cout + co));
      float v1 = aff1(acc[j][2 * e + 1], __ldg(aff + co + 1),
                      __ldg(aff + cout + co + 1));
      if (kind == HEADS) {
        *reinterpret_cast<uint32_t*>(hid + (py * tw + px) * kHidStride + cl) =
            pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        continue;
      }
      if (!inside) continue;
      const long long o = pix * cout + co;
      if (res_kind == RES_ADD) {
        const float2 s = unpack2(ldcg4(res + o));
        v0 += s.x;
        v1 += s.y;
      } else if (res_kind == RES_PROJ) {
        v0 += aff1(acc2[j][2 * e], __ldg(paff + co), __ldg(paff + cout + co));
        v1 += aff1(acc2[j][2 * e + 1], __ldg(paff + co + 1),
                   __ldg(paff + cout + co + 1));
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (res_kind == RES_SKIP) {
        const float2 s = unpack2(ldcg4(res + o));
        v0 = bf16_round(v0) + s.x;
        v1 = bf16_round(v1) + s.y;
      }
      *reinterpret_cast<uint32_t*>(out + o) = pack2(v0, v1);
    }
  }

  if (kind == HEADS) {
    // hm = hid[:32] . w_out[0, :32], size = hid[32:] . w_out[1:, 32:]
    // (the block-diagonal 64 -> 3 conv's nonzero halves), each sum over
    // its 32 channels in channel order, then the float32 bias
    __syncthreads();
    const bf16* wo = P.wts + op[F_O_W_OFF];          // (1, 3, 64)
    const float* ao = P.aff + op[F_O_AFF_OFF];        // (2, 3)
    for (int i = threadIdx.x; i < th * tw * 3; i += kThreads) {
      const int pl = i / 3, o = i - pl * 3;
      const int py = pl / tw, px = pl - py * tw;
      const int y = y0 + py, x = x0 + px;
      if (y >= H || x >= W) continue;
      const long long pix = ((long long)n * H + y) * W + x;
      const int cb = o == 0 ? 0 : 32;
      const bf16* h = hid + pl * kHidStride + cb;
      const bf16* wr = wo + o * 64 + cb;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < 32; ++c)
        s = fmaf(__bfloat162float(h[c]), __bfloat162float(wr[c]), s);
      const float v = aff1(s, __ldg(ao + o), __ldg(ao + 3 + o));
      if (o == 0)
        P.out[op[F_OUT_OFF] + pix] = v;
      else
        P.out[op[F_OUT2_OFF] + 2 * pix + o - 1] = v;
    }
  }
  __syncthreads();                 // the next tile restages shared memory
}

__global__ void __launch_bounds__(kThreads, 1)
centernet_bf16_kernel(Ptrs P, const int* __restrict__ ops_g,
                      const int* __restrict__ stages_g, int s_begin,
                      int s_end, int n_ops, int n_stages) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* smem = reinterpret_cast<bf16*>(smraw);
  // the tables, once: every tile reads its op's fields from shared memory
  __shared__ int ops[kMaxOps * kOpW];
  __shared__ int stages[2 * kMaxStages];
  for (int i = threadIdx.x; i < n_ops * kOpW; i += kThreads)
    ops[i] = ops_g[i];
  for (int i = threadIdx.x; i < 2 * n_stages; i += kThreads)
    stages[i] = stages_g[i];
  __syncthreads();
  // stage s's tile t: its op and the tile's index in the op
  auto find = [&](int s, int t, int& o, int& lt) {
    o = stages[2 * s];
    lt = t;
    while (o < stages[2 * s + 1] && lt >= ops[o * kOpW + F_TILES]) {
      lt -= ops[o * kOpW + F_TILES];
      ++o;
    }
    return o < stages[2 * s + 1];
  };
  // the op and channel slice whose weights the first buffer holds
  int held_op = -1, held_tc = -1;
  for (int s = s_begin; s < s_end; ++s) {
    int o, lt;
    for (int t = blockIdx.x; find(s, t, o, lt); t += gridDim.x) {
      const int* op = ops + o * kOpW;
      const bool one_chunk = op[F_CK] == op[F_CINP] && op[F_P_CIN] == 0;
      const int tc = lt % op[F_TILES_C];
      const bool held = one_chunk && o == held_op && tc == held_tc;
      switch (op[F_NF]) {
        case 1: run_tile<1>(op, P, lt, smem, held); break;
        case 2: run_tile<2>(op, P, lt, smem, held); break;
        default: run_tile<4>(op, P, lt, smem, held); break;
      }
      held_op = one_chunk ? o : -1;
      held_tc = tc;
    }
    if (s + 1 < s_end) {
      __threadfence();
      cg::this_grid().sync();
    }
  }
}

}  // namespace

// Stages [s_begin, s_end) of a bf16 plan (ops/kernels/centernet.py::
// centernet_bf16_plan): bev (B, H, W, J) float32; wts and aff the packed
// weights (packed["wflat"] bf16, packed["affflat"] float32); arena the
// bf16 intermediates; out hm (B, H, W) then size (B, H, W, 2), float32;
// ops (n_ops, 48) and stages (n_stages, 2) int32 tables (at most 24 ops
// and 20 stages); max_tiles the
// most tiles of any stage in the range, smem the plan's dynamic shared
// memory. More than one stage: one cooperative launch, its grid no larger
// than what is co-resident; one stage: a plain launch of max_tiles blocks.
FVP_API int fvp_centernet_bf16(const float* bev, const void* wts,
                               const float* aff, void* arena, float* out,
                               const int* ops, const int* stages,
                               int n_ops, int n_stages, int s_begin,
                               int s_end, int max_tiles, int smem,
                               int cooperative, void* stream) {
  if (n_ops > kMaxOps || n_stages > kMaxStages || s_begin < 0 ||
      s_end > n_stages || s_begin >= s_end)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      centernet_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  Ptrs P{bev, static_cast<const bf16*>(wts), aff, static_cast<bf16*>(arena),
         out};
  if (!cooperative) {
    centernet_bf16_kernel<<<max_tiles, kThreads, smem, s>>>(
        P, ops, stages, s_begin, s_end, n_ops, n_stages);
    return (int)cudaGetLastError();
  }
  // the co-resident grid, computed once per (device, shared memory)
  static int cached_dev = -1, cached_smem = -1, cached_grid = 0;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, centernet_bf16_kernel, kThreads, smem)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_grid = per_sm * sms;
  }
  const int grid = max_tiles < cached_grid ? max_tiles : cached_grid;
  void* args[] = {&P,       (void*)&ops, (void*)&stages, &s_begin,
                  &s_end,   &n_ops,      &n_stages};
  err = cudaLaunchCooperativeKernel((const void*)centernet_bf16_kernel,
                                    dim3(grid), dim3(kThreads), args,
                                    (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

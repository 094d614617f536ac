// K3 centernet: all of CenterNet in one persistent, cooperative launch.
//
// Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_centernet (one fused
// Pallas launch over the whole net, bf16 inside). This kernel computes in
// float32 (held at 1e-4 of the output scale against its plain version and
// against flax float32, which neither TF32 nor bf16 would meet).
//
// Bound on the H100: float32 operations, ~2.2 GFLOP at the flagship 80x80
// BEV (0.033 ms at 67 TFLOP/s); every tensor is under 1 MB and stays in
// L2. What held PR 1's layer-by-layer kernels back: 28 launches on small
// grids, each tap's input read from global memory, the weights read with
// __ldg on every FMA (2.2346 ms, NVIDIA H100 80GB HBM3 at 700 W). Design:
// - the host's plan (ops/kernels/centernet.py::centernet_plan) schedules
//   the net as 16 stages of ops and each op as output tiles (a patch of
//   4 x 8 pixel blocks x a slice of 16-channel blocks); one launch walks
//   the stages with a grid barrier between them (cooperative launch, the
//   grid no larger than what is co-resident), each block taking the
//   stage's tiles in turn;
// - fusions: the 2x2 max pool in the staging of the conv that reads it;
//   a ResBlock's 1x1 projection as extra K chunks with their own
//   accumulators and affine; the up-conv's skip add and the heads' two
//   1x1 convs (after one merged 32 -> 64 3x3 conv) in the epilogues;
// - a tile's input patch with its halo and the weights' K chunk are staged
//   in shared memory with cp.async, double-buffered over the K chunks
//   (input channels in chunks of up to 32, then the projection's), their
//   addresses without integer division (div_small);
// - one block of 256 threads per SM (__launch_bounds__(256, 1)): at two,
//   the 128-register cap spilled the accumulators (0.3867 against 0.2607
//   ms, fvp_torch/tools/kernel_parts.py, NVIDIA H100 80GB HBM3, 700 W);
// - 8 warps per block split the tile by pixel block, channel block and K
//   group (partial sums reduced through shared memory in a fixed order);
//   a lane holds 4 pixels (one column, 4 rows) x 4 channels of float32
//   accumulators: lanes 0-7 take 8 neighbouring pixels and lanes 8 apart
//   4 channel quads, so each 16-byte shared load of the input serves 4
//   lanes and of the weights 8 lanes, 8 loads per 64 FMAs;
// - intermediates written by one stage and read by a later one are read
//   through L2 (cp.async.cg, ld.global.cg), never the non-coherent paths.
// The float32 sums run in another order than cuDNN's.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kOpW = 48;  // ints per op in the table

// one op of the table (ops/kernels/centernet.py::OP_FIELDS, same order)
enum Field {
  F_KIND, F_K, F_H, F_W, F_CIN, F_COUT,
  F_IN_SRC, F_IN_OFF, F_IN_POOL, F_W_OFF, F_SC_OFF, F_SH_OFF, F_RELU,
  F_RES_KIND, F_RES_OFF,
  F_P_IN_OFF, F_P_CIN, F_P_POOL, F_P_W_OFF, F_P_SC_OFF, F_P_SH_OFF,
  F_OUT_OFF, F_OUT2_OFF,
  F_H1_W_OFF, F_H1_SC_OFF, F_H1_SH_OFF, F_H2_W_OFF, F_H2_SC_OFF,
  F_H2_SH_OFF,
  F_TH, F_TW, F_TN, F_WMR, F_WMC, F_WN, F_WK, F_CK, F_CKP,
  F_TILES_Y, F_TILES_X, F_TILES_C, F_TILES, F_XS, F_XSP, F_XF, F_WF,
};

enum Kind { CONV = 0, UPCONV = 1, HEADS = 2 };
enum Res { RES_NONE = 0, RES_ADD = 1, RES_PROJ = 2, RES_SKIP = 3 };

struct Ptrs {
  const float* bev;
  const float* wts;
  float* arena;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// arena data: written by other blocks in an earlier stage of this launch,
// so read through L2 only
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// a / b for 0 <= a < 2^22 and b > 0, by b's float reciprocal (exact:
// (a + 0.5) / b lies 0.5 / b or more from an integer, more than the
// ~1.2e-7 (a / b) of the product's rounding): no integer division in the
// staging loops
__device__ __forceinline__ int div_small(int a, float inv_b) {
  return (int)(((float)a + 0.5f) * inv_b);
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// acc[c] += x.e * w_e[c] for the four input channels e of a quad
__device__ __forceinline__ void fma_quad(float* acc, float4 x, float4 w0,
                                         float4 w1, float4 w2, float4 w3) {
  acc[0] = fmaf(x.x, w0.x, acc[0]);
  acc[1] = fmaf(x.x, w0.y, acc[1]);
  acc[2] = fmaf(x.x, w0.z, acc[2]);
  acc[3] = fmaf(x.x, w0.w, acc[3]);
  acc[0] = fmaf(x.y, w1.x, acc[0]);
  acc[1] = fmaf(x.y, w1.y, acc[1]);
  acc[2] = fmaf(x.y, w1.z, acc[2]);
  acc[3] = fmaf(x.y, w1.w, acc[3]);
  acc[0] = fmaf(x.z, w2.x, acc[0]);
  acc[1] = fmaf(x.z, w2.y, acc[1]);
  acc[2] = fmaf(x.z, w2.z, acc[2]);
  acc[3] = fmaf(x.z, w2.w, acc[3]);
  acc[0] = fmaf(x.w, w3.x, acc[0]);
  acc[1] = fmaf(x.w, w3.y, acc[1]);
  acc[2] = fmaf(x.w, w3.z, acc[2]);
  acc[3] = fmaf(x.w, w3.w, acc[3]);
}

// Stage an input patch: PH x PW pixels of channels [ci0, ci0 + ck) at
// pixel stride XS, from the (Hin, Win) map (a pooled map: the max of each
// 2x2 window of the (2 Hin, 2 Win) source), zero outside the map and past
// C channels. (oy, ox): the patch's first pixel in map coordinates.
__device__ void stage_x(float* xs, const float* src, int n, int C, int Hin,
                        int Win, bool pool, int oy, int ox, int PH, int PW,
                        int ci0, int ck, int XS) {
  const int nq = ck >> 2;
  const int total = PH * PW * nq;
  const float inv_nq = 1.f / (float)nq, inv_pw = 1.f / (float)PW;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = div_small(i, inv_nq), q = i - p * nq;
    const int py = div_small(p, inv_pw), px = p - py * PW;
    const int gy = oy + py, gx = ox + px, c = ci0 + 4 * q;
    float* dst = xs + p * XS + 4 * q;
    const bool inb = gy >= 0 && gy < Hin && gx >= 0 && gx < Win;
    if (pool) {                                   // C % 4 == 0
      float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inb && c < C) {
        const long long row = (long long)2 * Win * C;
        const float* s0 =
            src + (((long long)n * 2 * Hin + 2 * gy) * (2 * Win) + 2 * gx) *
                      C + c;
        m = max4(max4(ldcg4(s0), ldcg4(s0 + C)),
                 max4(ldcg4(s0 + row), ldcg4(s0 + row + C)));
      }
      *reinterpret_cast<float4*>(dst) = m;
    } else if ((C & 3) == 0) {
      const bool ok = inb && c < C;
      cp_async16(dst,
                 ok ? src + (((long long)n * Hin + gy) * Win + gx) * C + c
                    : src,
                 ok);
    } else {                                      // the BEV: J channels
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = inb && c + e < C;
        cp_async4(dst + e,
                  ok ? src + (((long long)n * Hin + gy) * Win + gx) * C + c +
                           e
                     : src,
                  ok);
      }
    }
  }
}

// Stage the weights of taps x [ci0, ci0 + ck) input channels x [c0, c0 +
// tn) output channels of a (taps, Cin, Cout) kernel: rows of tn floats,
// zero past Cin.
__device__ void stage_w(float* ws, const float* w, int taps, int Cin,
                        int Cout, int ci0, int ck, int c0, int tn) {
  const int nv = tn >> 2;                         // 4, 8 or 16
  const int lg = nv == 4 ? 2 : nv == 8 ? 3 : 4;
  const int total = taps * ck * nv;
  const float inv_ck = 1.f / (float)ck;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i >> lg, v = i & (nv - 1);
    const int tap = div_small(r, inv_ck), ci = ci0 + (r - tap * ck);
    const bool ok = ci < Cin;
    cp_async16(ws + r * tn + 4 * v,
               ok ? w + ((long long)(tap * Cin + ci) * Cout + c0 + 4 * v) : w,
               ok);
  }
}

// One K chunk of a k x k conv: the steps (tap, channel quad) of this
// warp's K group, kg, kg + wk, ...; the lane's pixels are rows pr..pr+3 of
// column pc of the tile, its channels wc..wc+3 of the tile's slice.
__device__ __forceinline__ void compute_conv(float (&acc)[4][4],
                                             const float* xs, const float* ws,
                                             int k, int ck, int XS, int PW,
                                             int tn, int kg, int wk, int pr,
                                             int pc, int wc) {
  const int nq = ck >> 2, taps = k * k;
  int q = kg, tap = 0;
  while (q >= nq) {
    q -= nq;
    ++tap;
  }
  int dy = tap / k, dx = tap - dy * k;
  while (tap < taps) {
    const float* wp = ws + (tap * ck + 4 * q) * tn + wc;
    const float4 w0 = lds4(wp), w1 = lds4(wp + tn), w2 = lds4(wp + 2 * tn),
                 w3 = lds4(wp + 3 * tn);
    const float* xp = xs + ((pr + dy) * PW + pc + dx) * XS + 4 * q;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fma_quad(acc[i], lds4(xp + i * PW * XS), w0, w1, w2, w3);
    q += wk;
    while (q >= nq) {
      q -= nq;
      ++tap;
      if (++dx == k) {
        dx = 0;
        ++dy;
      }
    }
  }
}

// One K chunk of the 2x2 stride-2 up-conv: output row pr + i has parity
// i & 1 and reads input row (pr + i) / 2; column pc has parity sp.
__device__ __forceinline__ void compute_up(float (&acc)[4][4],
                                           const float* xs, const float* ws,
                                           int ck, int XS, int PW, int tn,
                                           int kg, int wk, int pr, int pc,
                                           int wc) {
  const int nq = ck >> 2, sp = pc & 1;
  const float* wa0 = ws + (sp * ck) * tn + wc;          // tap (0, sp)
  const float* wb0 = ws + ((2 + sp) * ck) * tn + wc;    // tap (1, sp)
  const float* x00 = xs + ((pr >> 1) * PW + (pc >> 1)) * XS;
  for (int q = kg; q < nq; q += wk) {
    const float* wa = wa0 + 4 * q * tn;
    const float* wb = wb0 + 4 * q * tn;
    const float4 a0 = lds4(wa), a1 = lds4(wa + tn), a2 = lds4(wa + 2 * tn),
                 a3 = lds4(wa + 3 * tn);
    const float4 b0 = lds4(wb), b1 = lds4(wb + tn), b2 = lds4(wb + 2 * tn),
                 b3 = lds4(wb + 3 * tn);
    const float4 xa = lds4(x00 + 4 * q), xb = lds4(x00 + PW * XS + 4 * q);
    fma_quad(acc[0], xa, a0, a1, a2, a3);
    fma_quad(acc[1], xa, b0, b1, b2, b3);
    fma_quad(acc[2], xb, a0, a1, a2, a3);
    fma_quad(acc[3], xb, b0, b1, b2, b3);
  }
}

__device__ __forceinline__ float4 affine(const float* a, float4 sc,
                                         float4 sh) {
  return make_float4(fmaf(a[0], sc.x, sh.x), fmaf(a[1], sc.y, sh.y),
                     fmaf(a[2], sc.z, sh.z), fmaf(a[3], sc.w, sh.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}

__device__ void run_tile(const int* __restrict__ op, const Ptrs& P, int t,
                         float* smem) {
  const int kind = op[F_KIND], k = op[F_K];
  const int H = op[F_H], W = op[F_W], cin = op[F_CIN], cout = op[F_COUT];
  const int th = op[F_TH], tw = op[F_TW], tn = op[F_TN];
  const int wmc = op[F_WMC], wn = op[F_WN], wk = op[F_WK];
  const int ck = op[F_CK], ckp = op[F_CKP], p_cin = op[F_P_CIN];
  const int xf = op[F_XF], wf = op[F_WF];
  const int res_kind = op[F_RES_KIND];

  // the tile: channel slice fastest, then columns, rows, batch
  const int tiles_c = op[F_TILES_C], tiles_x = op[F_TILES_X],
            tiles_y = op[F_TILES_Y];
  int r = t;
  const int tc = r % tiles_c;
  r /= tiles_c;
  const int tx = r % tiles_x;
  r /= tiles_x;
  const int ty = r % tiles_y;
  const int n = r / tiles_y;
  const int c0 = tc * tn, x0 = tx * tw, y0 = ty * th;

  // the warp's part: K group, channel block, pixel block
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = wid % wk, rest = wid / wk;
  const int ng = rest % wn, mg = rest / wn;
  const int pr = (mg / wmc) * 4, pc = (mg % wmc) * 8 + (lane & 7);
  const int wc = ng * 16 + (lane >> 3) * 4;

  const float* in = op[F_IN_SRC] == 0 ? P.bev : P.arena + op[F_IN_OFF];
  const float* pin = P.arena + op[F_P_IN_OFF];
  const float* w = P.wts + op[F_W_OFF];
  const float* pw = P.wts + op[F_P_W_OFF];
  const bool pool = op[F_IN_POOL] != 0, ppool = op[F_P_POOL] != 0;
  const int nch_main = (cin + ck - 1) / ck;
  const int nch = nch_main + (p_cin ? (p_cin + ckp - 1) / ckp : 0);
  const int pad = k >> 1;

  auto stage = [&](int ch, int buf) {
    float* xs = smem + buf * (xf + wf);
    float* ws = xs + xf;
    if (ch < nch_main) {
      const int ci0 = ch * ck;
      if (kind == UPCONV) {
        stage_x(xs, in, n, cin, H >> 1, W >> 1, false, y0 >> 1, x0 >> 1,
                th >> 1, tw >> 1, ci0, ck, op[F_XS]);
        stage_w(ws, w, 4, cin, cout, ci0, ck, c0, tn);
      } else {
        stage_x(xs, in, n, cin, H, W, pool, y0 - pad, x0 - pad, th + k - 1,
                tw + k - 1, ci0, ck, op[F_XS]);
        stage_w(ws, w, k * k, cin, cout, ci0, ck, c0, tn);
      }
    } else {
      const int ci0 = (ch - nch_main) * ckp;
      stage_x(xs, pin, n, p_cin, H, W, ppool, y0, x0, th, tw, ci0, ckp,
              op[F_XSP]);
      stage_w(ws, pw, 1, p_cin, cout, ci0, ckp, c0, tn);
    }
  };

  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = acc2[i][c] = 0.f;

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
    const float* xs = smem + (ch & 1) * (xf + wf);
    const float* ws = xs + xf;
    if (ch >= nch_main)
      compute_conv(acc2, xs, ws, 1, ckp, op[F_XSP], tw, tn, kg, wk, pr, pc,
                   wc);
    else if (kind == UPCONV)
      compute_up(acc, xs, ws, ck, op[F_XS], tw >> 1, tn, kg, wk, pr, pc, wc);
    else
      compute_conv(acc, xs, ws, k, ck, op[F_XS], tw + k - 1, tn, kg, wk, pr,
                   pc, wc);
    __syncthreads();
  }

  // the K groups' partial sums, added in group order
  const int wm = op[F_WMR] * wmc;
  float* hid = smem + (wk - 1) * th * tw * tn;
  if (wk > 1) {
    const int NT = wm * wn * 32, lt = (mg * wn + ng) * 32 + lane;
    float* red = smem;
    float* red2 = smem + (wk - 1) * 16 * NT;
    if (kg > 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        red[((kg - 1) * 16 + e) * NT + lt] = acc[e >> 2][e & 3];
        if (p_cin) red2[((kg - 1) * 16 + e) * NT + lt] = acc2[e >> 2][e & 3];
      }
    }
    __syncthreads();
    if (kg == 0) {
      for (int g = 1; g < wk; ++g) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          acc[e >> 2][e & 3] += red[((g - 1) * 16 + e) * NT + lt];
          if (p_cin) acc2[e >> 2][e & 3] += red2[((g - 1) * 16 + e) * NT + lt];
        }
      }
    }
  }

  if (kg == 0) {
    const int co = c0 + wc;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(
                          P.wts + op[F_SC_OFF] + co)),
                 sh = __ldg(reinterpret_cast<const float4*>(
                          P.wts + op[F_SH_OFF] + co));
    float4 psc = sc, psh = sh;
    if (res_kind == RES_PROJ) {
      psc = __ldg(reinterpret_cast<const float4*>(P.wts + op[F_P_SC_OFF] +
                                                  co));
      psh = __ldg(reinterpret_cast<const float4*>(P.wts + op[F_P_SH_OFF] +
                                                  co));
    }
    const bool relu = op[F_RELU] != 0;
    float* out = P.arena + op[F_OUT_OFF];
    const float* res = P.arena + op[F_RES_OFF];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = y0 + pr + i, x = x0 + pc;
      float4 v = affine(acc[i], sc, sh);
      if (kind == HEADS) {
        *reinterpret_cast<float4*>(hid + ((pr + i) * tw + pc) * 68 + wc) =
            relu4(v);
        continue;
      }
      if (y >= H || x >= W) continue;
      const long long o = (((long long)n * H + y) * W + x) * cout + co;
      if (res_kind == RES_ADD) v = add4(v, ldcg4(res + o));
      if (res_kind == RES_PROJ) v = add4(v, affine(acc2[i], psc, psh));
      if (relu) v = relu4(v);
      if (res_kind == RES_SKIP) v = add4(v, ldcg4(res + o));
      *reinterpret_cast<float4*>(out + o) = v;
    }
  }

  if (kind == HEADS) {
    // hm = hid[:32] . w_hm, size = hid[32:] . w_size: the 1x1 convs, each
    // output sum over its 32 channels in channel order
    __syncthreads();
    const float* w1 = P.wts + op[F_H1_W_OFF];
    const float* w2 = P.wts + op[F_H2_W_OFF];
    for (int i = threadIdx.x; i < th * tw * 3; i += kThreads) {
      const int pl = i / 3, o = i - pl * 3;
      const int py = pl / tw, px = pl - py * tw;
      const int y = y0 + py, x = x0 + px;
      if (y >= H || x >= W) continue;
      const long long pix = ((long long)n * H + y) * W + x;
      const float* h = hid + pl * 68;
      float s = 0.f;
      if (o == 0) {
        for (int c = 0; c < 32; ++c) s = fmaf(h[c], __ldg(w1 + c), s);
        P.arena[op[F_OUT_OFF] + pix] =
            fmaf(s, __ldg(P.wts + op[F_H1_SC_OFF]),
                 __ldg(P.wts + op[F_H1_SH_OFF]));
      } else {
        for (int c = 0; c < 32; ++c)
          s = fmaf(h[32 + c], __ldg(w2 + 2 * c + o - 1), s);
        P.arena[op[F_OUT2_OFF] + 2 * pix + o - 1] =
            fmaf(s, __ldg(P.wts + op[F_H2_SC_OFF] + o - 1),
                 __ldg(P.wts + op[F_H2_SH_OFF] + o - 1));
      }
    }
  }
  __syncthreads();                 // the next tile restages shared memory
}

__global__ void __launch_bounds__(kThreads, 1)
centernet_kernel(Ptrs P, const int* __restrict__ ops,
                 const int* __restrict__ stages, int s_begin, int s_end) {
  extern __shared__ __align__(16) float smem[];
  for (int s = s_begin; s < s_end; ++s) {
    const int a = stages[2 * s], b = stages[2 * s + 1];
    int total = 0;
    for (int o = a; o < b; ++o) total += ops[o * kOpW + F_TILES];
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int o = a, lt = t;
      while (lt >= ops[o * kOpW + F_TILES]) {
        lt -= ops[o * kOpW + F_TILES];
        ++o;
      }
      run_tile(ops + o * kOpW, P, lt, smem);
    }
    if (s + 1 < s_end) {
      __threadfence();
      cg::this_grid().sync();
    }
  }
}

}  // namespace

// Stages [s_begin, s_end) of a plan (ops/kernels/centernet.py): bev
// (B, H, W, J); wts the packed weights (packed["flat"]); arena the
// intermediates and outputs; ops (n_ops, 48) and stages (n_stages, 2)
// int32 tables; max_tiles the most tiles of any stage in the range, smem
// the plan's dynamic shared memory. More than one stage: one cooperative
// launch, its grid no larger than what is co-resident; one stage: a plain
// launch of max_tiles blocks.
FVP_API int fvp_centernet(const float* bev, const float* wts, float* arena,
                          const int* ops, const int* stages, int s_begin,
                          int s_end, int max_tiles, int smem,
                          int cooperative, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      centernet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Ptrs P{bev, wts, arena};
  if (!cooperative) {
    centernet_kernel<<<max_tiles, kThreads, smem, s>>>(P, ops, stages,
                                                       s_begin, s_end);
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
             &per_sm, centernet_kernel, kThreads, smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_grid = per_sm * sms;
  }
  const int grid = max_tiles < cached_grid ? max_tiles : cached_grid;
  void* args[] = {&P, (void*)&ops, (void*)&stages, &s_begin, &s_end};
  err = cudaLaunchCooperativeKernel((const void*)centernet_kernel,
                                    dim3(grid), dim3(kThreads), args,
                                    (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

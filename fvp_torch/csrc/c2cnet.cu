// c2cnet: all of C2CNet, the HDN's 1D hourglass over the proposals'
// z-columns, in one launch: (N, Z, J) float32 columns -> (N, Z) float32.
//
// Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_c2cnet (`_c2c_kernel`),
// which runs the net for all columns in one grid step with the items on
// the sublanes, so that each layer is one matrix product over all of them.
// The net does ~2.4e6 multiply-adds per column on 0.76 MB of bf16 weights:
// at B = 1 (10 columns) its time is bound by the chain of 23 dependent
// layers, not by operations or bytes. Design (ops/kernels/c2cnet.py
// documents the plan):
// - each layer is one implicit GEMM over every column of a CTA on
//   mma.sync m16n8k16 (bf16 operands, float32 sums): rows are (column,
//   height), K is (tap, input channel) in k16 steps, the columns are the
//   output channels (2F for an up-conv, column r F + f being output
//   2z + r). Activations stay in shared memory as bf16 rows of (channels
//   + 8) values with a zero halo row above and below each column, so a
//   tap is a row offset and the A fragments are 32-bit loads without
//   bank conflicts;
// - a ResBlock's 1x1 projection shares its first conv's GEMM (its own
//   accumulators on the centre tap, a float32 epilogue into P), and the
//   2x2 max pool runs in the epilogue of the conv that feeds it (the row
//   pair's values meet through one shuffle), so the net is 19 GEMM phases
//   and the output conv;
// - each CTA takes a few columns (at B = 1, five CTAs of two columns)
//   and holds all of their activations; a block barrier ends each phase.
//   (Splitting a phase's output channels over a thread-block cluster of
//   2 or 4 CTAs, each storing its slice into every CTA's copy, was slower
//   at every size measured: PERF.md);
// - a phase's weights, pre-packed in the order of the B fragments
//   (engine/packing.py::pack_c2cnet), arrive by bulk copy into a ring of
//   two slots (one where a tall column leaves no room) with the phase's
//   affines, so the next phases' weights are
//   in flight while this one computes and the epilogue reads shared
//   memory only; a warp reads its B fragment as one 8-byte load per lane.
// Each warp takes items of one m16 tile by two n8 tiles; each k16 step's
// mma sums its 16 products into fresh accumulators, which float32 adds
// bring into the item's sums in K order (so the mma do not wait on each
// other), all steps unrolled for the phases' shapes (gemm_item).
//
// Numerics (the TPU kernel's): the input rounds to bf16; the front conv and
// each ResBlock's first conv round relu(aff(conv)); a projection skip stays
// float32; the join relu(aff(conv) + skip) rounds; an up-conv rounds
// relu(aff(.)), adds the bf16 skip and rounds again; the 1x1 output conv
// adds its bias in float32. The affine and the skip add are the plain
// version's separate float32 operations (no contraction into an FMA), so
// only the order of the GEMM's sums differs from it.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace fvp;

constexpr int kThreads = 256, kWarps = kThreads / 32;
// n8 tiles of an item (one m16 tile): two, their mma sharing each A
// fragment (faster than one tile on 16 warps: tools/kernel_parts.py)
constexpr int kItemTiles = 2;
constexpr int kMaxPhases = 24, kNF = 26, kMaxDepth = 2;
constexpr int kFrag = 256;               // bytes of one n8 x k16 B fragment

// the fields of a phase (ops/kernels/c2cnet.py::FIELDS, in its order)
enum Field {
  kKind, kIn, kInStride, kInRpc, kInBase, kZl, kTaps, kCsteps, kNcols,
  kFo, kOut, kOutStride, kOutRpc, kRes, kResOff, kRelu, kPool, kPoolRpc,
  kProj, kW, kPW, kAff, kPAff, kP, kFieldCount
};
enum Kind { CONV = 0, UPCONV = 1, FINAL = 2 };
enum Res { RES_NONE = 0, RES_BF16 = 1, RES_PROJ = 2 };
static_assert(kFieldCount <= kNF, "table width");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// bulk copy of `bytes` (a multiple of 16) from global to this CTA's shared
// memory, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// one thread: the weights of phase `ph` into a ring slot, then the
// phase's affine (2, F) float32 and its projection's (so that the epilogue
// reads them from shared memory)
__device__ void issue(const int* ph, uint32_t slot, uint32_t bar,
                      const unsigned char* wfrag, const float* aff) {
  const int nt = ph[kNcols] / 8, ks = ph[kTaps] * ph[kCsteps];
  const uint32_t b1 = (uint32_t)nt * ks * kFrag;
  const uint32_t b2 = ph[kProj] ? (uint32_t)nt * ph[kCsteps] * kFrag : 0u;
  const uint32_t ba = 8u * ph[kFo];
  mbar_expect_tx(bar, b1 + b2 + ba * (ph[kProj] ? 2 : 1));
  bulk_load(slot, wfrag + ph[kW], b1, bar);
  if (b2) bulk_load(slot + b1, wfrag + ph[kPW], b2, bar);
  bulk_load(slot + b1 + b2, aff + ph[kAff], ba, bar);
  if (b2) bulk_load(slot + b1 + b2 + ba, aff + ph[kPAff], ba, bar);
}

// rows of a level's buffer: (column, z) with one halo row on each side
__device__ __forceinline__ int out_row(int n, int z, int rpc) {
  return n * rpc + 1 + z;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A B over one k16 step into fresh accumulators, added to acc in
// float32 (round to nearest): the steps' sums in K order, and the mma of
// one step independent of the others'
__device__ __forceinline__ void mma_add(float (&acc)[4],
                                        const uint32_t (&a)[4], uint2 b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(d, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The GEMM of one item: the A rows of tap 0 at pa (row g) and pb (row
// g + 8), the B fragments of its two n8 tiles at w0 and w1 (w1 == w0 where
// the second tile is past the slice: computed, never stored), and, on the
// centre tap of a phase with a projection, the projection's at q0, q1.
// K in k16 steps (tap t, channels 16 kc), each step's mma into fresh
// accumulators added to acc in order. TAPS, CS and PROJ as template
// arguments unroll all steps, so every fragment load and mma can be
// issued ahead of the adds that need it.
template <int TAPS, int CS, bool PROJ>
__device__ __forceinline__ void gemm_item(float (&acc)[2][4],
                                          float (&pacc)[2][4], const bf16* pa,
                                          const bf16* pb, int istr,
                                          const uint2* w0, const uint2* w1,
                                          const uint2* q0, const uint2* q1) {
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int kc = 0; kc < CS; ++kc) {
      const int st = t * CS + kc;
      const uint32_t a[4] = {ld32(pa + t * istr + 16 * kc),
                             ld32(pb + t * istr + 16 * kc),
                             ld32(pa + t * istr + 16 * kc + 8),
                             ld32(pb + t * istr + 16 * kc + 8)};
      mma_add(acc[0], a, w0[st * 32]);
      mma_add(acc[1], a, w1[st * 32]);
      if (PROJ && t == TAPS / 2) {
        mma_add(pacc[0], a, q0[kc * 32]);
        mma_add(pacc[1], a, q1[kc * 32]);
      }
    }
}

// the same for any taps and channel steps (a front with more than 32
// joints), in the same order of sums
__device__ void gemm_item_any(float (&acc)[2][4], float (&pacc)[2][4],
                              const bf16* pa, const bf16* pb, int istr,
                              const uint2* w0, const uint2* w1,
                              const uint2* q0, const uint2* q1, int taps,
                              int csteps, bool proj) {
  for (int t = 0; t < taps; ++t)
    for (int kc = 0; kc < csteps; ++kc) {
      const int st = t * csteps + kc;
      const uint32_t a[4] = {ld32(pa + t * istr + 16 * kc),
                             ld32(pb + t * istr + 16 * kc),
                             ld32(pa + t * istr + 16 * kc + 8),
                             ld32(pb + t * istr + 16 * kc + 8)};
      mma_add(acc[0], a, w0[st * 32]);
      mma_add(acc[1], a, w1[st * 32]);
      if (proj && t == taps / 2) {
        mma_add(pacc[0], a, q0[kc * 32]);
        mma_add(pacc[1], a, q1[kc * 32]);
      }
    }
}

// a u32 (two bf16 values) at byte offset `off` of shared memory
__device__ __forceinline__ void put(unsigned char* sm, uint32_t off,
                                    uint32_t v) {
  *reinterpret_cast<uint32_t*>(sm + off) = v;
}

// One GEMM phase of this CTA: its items of one m16 tile x kItemTiles n8
// tiles over its warps, then the epilogue of each item.
__device__ void gemm_phase(const int* ph, unsigned char* sm,
                           const unsigned char* wslot, int nh, int warp,
                           int lane) {
  const int zl = ph[kZl], M = nh * zl, mtiles = (M + 15) / 16;
  const int nloc = ph[kNcols] / 8;
  const int per_mt = (nloc + kItemTiles - 1) / kItemTiles;
  const int items = mtiles * per_mt;
  const int taps = ph[kTaps], csteps = ph[kCsteps], ks = taps * csteps;
  const bool proj = ph[kProj] != 0;
  const int istr = ph[kInStride], irpc = ph[kInRpc], ibase = ph[kInBase];
  const bf16* in = reinterpret_cast<const bf16*>(sm + ph[kIn]);
  const uint2* wb = reinterpret_cast<const uint2*>(wslot);
  const uint2* pw = reinterpret_cast<const uint2*>(wslot + nloc * ks * kFrag);
  const int g = lane >> 2, t4 = lane & 3;
  const int kind = ph[kKind], fo = ph[kFo];
  const int ostr = ph[kOutStride], orpc = ph[kOutRpc];
  const int res = ph[kRes], relu = ph[kRelu];
  const int pool = ph[kPool], prpc = ph[kPoolRpc];
  const int fs = nloc * 8;                 // the projection's width
  float* P = reinterpret_cast<float*>(sm + ph[kP]);
  // the affines, after the weights in the slot
  const float* sc = reinterpret_cast<const float*>(
      wslot + nloc * ks * kFrag + (proj ? nloc * csteps * kFrag : 0));
  const float* psc = sc + 2 * fo;
  const int key = (taps << 8) | (csteps << 1) | (proj ? 1 : 0);
  const int fsh = __ffs(fo) - 1;           // F is a power of two

  for (int it = warp; it < items; it += kWarps) {
    const int mt = it / per_mt;
    const int j0 = kItemTiles * (it % per_mt);   // local n8 tile
    const bool two = kItemTiles == 2 && j0 + 1 < nloc;
    // rows 16 mt + g + 8 h of this lane (clamped to the last row where
    // the tile runs past M: computed, never stored)
    int mm[2], nn[2], zz[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mm[h] = 16 * mt + g + 8 * h;
      const int mc = min(mm[h], M - 1);
      nn[h] = mc / zl;
      zz[h] = mc - nn[h] * zl;
    }
    const bf16* pa = in + (nn[0] * irpc + ibase + zz[0]) * istr + 2 * t4;
    const bf16* pb = in + (nn[1] * irpc + ibase + zz[1]) * istr + 2 * t4;
    const uint2* w0 = wb + j0 * ks * 32 + lane;
    const uint2* w1 = two ? w0 + ks * 32 : w0;
    const uint2* q0 = pw + j0 * csteps * 32 + lane;
    const uint2* q1 = two ? q0 + csteps * 32 : q0;
    float acc[2][4] = {}, pacc[2][4] = {};
    switch (key) {
#define FVP_GEMM(T, C, PR)                                                 \
  case ((T) << 8) | ((C) << 1) | (PR):                                      \
    gemm_item<T, C, (PR) != 0>(acc, pacc, pa, pb, istr, w0, w1, q0, q1); \
    break;
      FVP_GEMM(7, 1, 0)
      FVP_GEMM(7, 2, 0)
      FVP_GEMM(3, 1, 0)
      FVP_GEMM(3, 1, 1)
      FVP_GEMM(3, 2, 0)
      FVP_GEMM(3, 2, 1)
      FVP_GEMM(3, 4, 0)
      FVP_GEMM(3, 4, 1)
      FVP_GEMM(3, 8, 0)
      FVP_GEMM(1, 4, 0)
      FVP_GEMM(1, 8, 0)
#undef FVP_GEMM
      default:
        gemm_item_any(acc, pacc, pa, pb, istr, w0, w1, q0, q1, taps, csteps,
                      proj);
    }

    // epilogue: rows mm[h], columns 8 (lo + j0 + j) + 2 t4 + e; loads and
    // shuffles on every lane, stores on the rows inside M
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !two) break;             // warp-uniform
      const int col = 8 * (j0 + j) + 2 * t4;
      const int fcol = kind == UPCONV ? col & (fo - 1) : col;
      const float s0 = sc[fcol], s1 = sc[fcol + 1];
      const float h0 = sc[fo + fcol], h1 = sc[fo + fcol + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool valid = mm[h] < M;
        const int n = nn[h], z = zz[h];
        float v0 = __fadd_rn(__fmul_rn(acc[j][2 * h], s0), h0);
        float v1 = __fadd_rn(__fmul_rn(acc[j][2 * h + 1], s1), h1);
        if (kind == UPCONV) {                // warp-uniform
          const int zo = 2 * z + (col >> fsh), row = out_row(n, zo, orpc);
          const uint32_t s = *reinterpret_cast<const uint32_t*>(
              sm + ph[kResOff] + 2 * (row * ostr + fcol));
          const uint32_t y = pack2(
              __fadd_rn(__bfloat162float(__float2bfloat16_rn(fmaxf(v0, 0.f))),
                        bf_lo(s)),
              __fadd_rn(__bfloat162float(__float2bfloat16_rn(fmaxf(v1, 0.f))),
                        bf_hi(s)));
          if (valid) {
            put(sm, ph[kOut] + 2 * (row * ostr + fcol), y);
            if (zo == 0)
              put(sm, ph[kOut] + 2 * ((row - 1) * ostr + fcol), 0u);
            if (zo == 2 * zl - 1)
              put(sm, ph[kOut] + 2 * ((row + 1) * ostr + fcol), 0u);
          }
          continue;
        }
        const int row = out_row(n, z, orpc);
        if (res == RES_BF16) {               // warp-uniform
          const uint32_t s = *reinterpret_cast<const uint32_t*>(
              sm + ph[kResOff] + 2 * (row * ostr + col));
          v0 = __fadd_rn(v0, bf_lo(s));
          v1 = __fadd_rn(v1, bf_hi(s));
        } else if (res == RES_PROJ) {
          const float2 s = *reinterpret_cast<const float2*>(
              P + min(mm[h], M - 1) * fs + col);
          v0 = __fadd_rn(v0, s.x);
          v1 = __fadd_rn(v1, s.y);
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const uint32_t y = pack2(v0, v1);
        if (valid) {
          put(sm, ph[kOut] + 2 * (row * ostr + col), y);
          if (z == 0)
            put(sm, ph[kOut] + 2 * ((row - 1) * ostr + col), 0u);
          if (z == zl - 1)
            put(sm, ph[kOut] + 2 * ((row + 1) * ostr + col), 0u);
        }
        if (pool >= 0) {                     // warp-uniform
          // rows m and m + 1 (an even m) are lanes l and l ^ 4
          const uint32_t o = __shfl_xor_sync(0xffffffffu, y, 4);
          const int zp = z >> 1, prow = out_row(n, zp, prpc);
          const uint32_t pv = pack2(fmaxf(bf_lo(y), bf_lo(o)),
                                    fmaxf(bf_hi(y), bf_hi(o)));
          if (valid && (g & 1) == 0) {
            put(sm, pool + 2 * (prow * ostr + col), pv);
            if (zp == 0)
              put(sm, pool + 2 * ((prow - 1) * ostr + col), 0u);
            if (zp == zl / 2 - 1)
              put(sm, pool + 2 * ((prow + 1) * ostr + col), 0u);
          }
        }
        if (proj && valid) {                 // the projection: float32
          const float2 p = make_float2(
              __fadd_rn(__fmul_rn(pacc[j][2 * h], psc[col]), psc[fo + col]),
              __fadd_rn(__fmul_rn(pacc[j][2 * h + 1], psc[col + 1]),
                        psc[fo + col + 1]));
          *reinterpret_cast<float2*>(P + mm[h] * fs + col) = p;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
c2cnet_kernel(const float* __restrict__ cols,
              const unsigned char* __restrict__ wfrag,
              const bf16* __restrict__ wflat, const float* __restrict__ aff,
              const int* __restrict__ table, float* __restrict__ out, int N,
              int Z, int J, int cpc, int nph, int depth, int slot_bytes,
              int bar_off, int x_off, int x_stride, int smem_bytes) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ int tab[kMaxPhases * kNF];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * cpc, nh = min(cpc, N - n0);
  const uint32_t sbase = smem_u32(sm);
  const int ngemm = nph - 1;

  for (int i = tid; i < nph * kNF; i += kThreads) tab[i] = table[i];
  // the activations start at zero (halo rows, padded input channels)
  for (int i = x_off / 16 + tid; i < smem_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int d = 0; d < depth; ++d) mbar_init(sbase + bar_off + 8 * d, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int p = 0; p < depth && p < ngemm; ++p)
      issue(&tab[p * kNF], sbase + p * slot_bytes, sbase + bar_off + 8 * p,
            wfrag, aff);
  // the CTA's columns, rounded to bf16: (Z + 6) rows of x_stride
  bf16* X = reinterpret_cast<bf16*>(sm + x_off);
  const float* src = cols + (long long)n0 * Z * J;
  for (int i = tid; i < nh * Z * J; i += kThreads) {
    const int n = i / (Z * J), r = i - n * Z * J, z = r / J, c = r - z * J;
    X[(n * (Z + 6) + 3 + z) * x_stride + c] = __float2bfloat16_rn(src[i]);
  }
  __syncthreads();

  for (int p = 0; p < ngemm; ++p) {
    const int slot = p % depth;
    mbar_wait(sbase + bar_off + 8 * slot, (p / depth) & 1);
    gemm_phase(&tab[p * kNF], sm, sm + slot * slot_bytes, nh, warp, lane);
    __syncthreads();
    // the last warp has the fewest items: it refills the slot
    if (tid == kThreads - 32 && p + depth < ngemm)
      issue(&tab[(p + depth) * kNF], sbase + slot * slot_bytes,
            sbase + bar_off + 8 * slot, wfrag, aff);
  }

  // the 1x1 output conv, float32
  const int* ph = &tab[ngemm * kNF];
  const int zl = ph[kZl], M = nh * zl, cin = 16 * ph[kCsteps];
  const bf16* in = reinterpret_cast<const bf16*>(sm + ph[kIn]);
  const bf16* w = wflat + ph[kW];
  const float a = aff[ph[kAff]], b = aff[ph[kAff] + 1];
  for (int m = tid; m < M; m += kThreads) {
    const int n = m / zl, z = m - n * zl;
    const bf16* x = in + (n * ph[kInRpc] + ph[kInBase] + z) * ph[kInStride];
    float acc = 0.f;
    for (int c = 0; c < cin; ++c)
      acc = fmaf(__bfloat162float(x[c]), __bfloat162float(w[c]), acc);
    out[(long long)(n0 + n) * Z + z] = __fadd_rn(__fmul_rn(acc, a), b);
  }
}

}  // namespace

// cols (N, Z, J) float32; wfrag the GEMM weights in fragment order; wflat
// the flat weights (the output conv's at the final phase's w_off); aff the
// flat affines; table the plan's phases (nph x 26 int32); out (N, Z)
// float32. The launch is ceil(N / cpc) CTAs of cpc columns, each with
// smem_bytes of dynamic shared memory (ops/kernels/c2cnet.py::c2cnet_plan).
FVP_API int fvp_c2cnet(const float* cols, const void* wfrag, const void* wflat,
                       const float* aff, const int* table, float* out, int N,
                       int Z, int J, int cpc, int nph, int depth,
                       int slot_bytes, int bar_off, int x_off, int x_stride,
                       int smem_bytes, void* stream) {
  if (N <= 0 || Z <= 0 || Z % 4 || J <= 0 || cpc <= 0 || nph < 2 ||
      nph > kMaxPhases || depth < 1 || depth > kMaxDepth || slot_bytes % 128 ||
      x_off % 16 || smem_bytes % 16 || smem_bytes < x_off)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;
  if (smem_bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        c2cnet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem_bytes;
  }
  c2cnet_kernel<<<(N + cpc - 1) / cpc, kThreads, smem_bytes,
                  (cudaStream_t)stream>>>(
      cols, static_cast<const unsigned char*>(wfrag),
      static_cast<const __nv_bfloat16*>(wflat), aff, table, out, N, Z, J, cpc,
      nph, depth, slot_bytes, bar_off, x_off, x_stride, smem_bytes);
  return (int)cudaGetLastError();
}

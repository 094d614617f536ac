// deconv_stage: one stage of the backbone's deconv head,
// ConvTranspose2d(k=4, s=2, p=1) + folded BN affine + ReLU, NHWC, bf16 out.
//
// Replaces fvp_tpu/ops/pallas/deconv_head.py::deconv_stage_rows and
// ::deconv_stage_chunked (one kernel for all three stages: streaming Cin in
// chunks was a VMEM workaround of the TPU). Output y[oy, ox] has parity
// r = (oy+1) % 2, source row i' = (oy+1) / 2 (likewise s, j' for x), and is
//   sum_{u,v in {0,1}} x[i'+u-1, j'+v-1, :] . W[2r+s][2u+v]   (zero outside)
// so each parity class is a GEMM (V*H*W) x (4*Cin) by (4*Cin) x F. With
// hi = i' - (1-r), source pixel (hi, wi) of parity (r, s) writes output
// (2*hi+1-r, 2*wi+1-s) and tap (u, v) reads x[hi+u-r, wi+v-s]: the SAME crop
// of the TPU kernel's padded grid is folded into the indexing, and the
// kernel writes the interleaved (V, 2H, 2W, F) map directly.
//
// Numerics: x is bf16 (the wrapper rounds the trunk's float32 output to bf16
// once, round to nearest even), weights are bf16, products sum in float32 on
// the tensor cores, the affine and ReLU apply to the float32 sum, and the
// result rounds to bf16 - the TPU kernel's numerics.
//
// Bound on the H100: operations. The head does 1.41e11 per 5-view frame
// (8.05e9, 4.03e9 and 1.61e10 per view for the three stages) against ~60 MB
// of traffic: 0.14 ms at the bf16 tensor-core peak. Design, for Hopper's
// tensor cores:
// - M tile: a th x tw patch (th*tw = 128) of source pixels of one view and
//   one parity class; N tile: BN = 256 output channels (128 where F is not
//   a multiple of 256); K in blocks of 64 input channels of one tap.
// - A by TMA: a 4D tensor map over x (Cin, W, H, V) with a (64, tw, th, 1)
//   box and 128-byte swizzle. Tap (u, v) is the same box at (w0+v-s,
//   h0+u-r): TMA's zero fill for coordinates outside x (negative ones too)
//   is the SAME padding, and the box lands as wgmma's K-major A operand.
// - B by TMA from pack_deconv_weight's (4, 4, Cin, F) layout, read
//   MN-major (F contiguous) through wgmma's transpose bit: BN/64 boxes of
//   64 x 64 per k block.
// - A ring of 3-4 stages in dynamic shared memory guarded by mbarriers
//   (full: TMA bytes; empty: the 8 consumer warps). One producer thread
//   issues the loads; two consumer warpgroups (64 rows each) issue wgmma
//   m64nBNk16 and keep one group in flight. setmaxnreg moves registers
//   from the producer warpgroup to the consumers.
// - Where the tiles fill the card (stages 2 and 3), one persistent CTA per
//   SM walks the tiles; the producer loads the next tile while the
//   consumers finish the last. Epilogue from the accumulators: affine,
//   ReLU, bf16, stmatrix into a staged tile, then one bulk copy per output
//   pixel (BN contiguous channels of the interleaved map; rows outside the
//   image skipped), left in flight while the next tile multiplies.
// - Where they do not (stage 1: 80 tiles of K = 8192), K is split across a
//   4-CTA thread-block cluster: each CTA leaves its float32 partial tile in
//   its drained ring, and CTA q of the cluster sums rows [q, q+1) * 128/4
//   over the four in rank order (a fixed order) through distributed shared
//   memory, then applies the epilogue to them: 320 CTAs, 2.4 per SM.
// The tiling (th, tw, BN, the split, the CTA count) is chosen by
// ops/kernels/deconv_head.py::deconv_plan, which the CPU tests check.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128, BK = 64;    // BK: the channels of one TMA box
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr int kABytes = BM * BK * 2;
constexpr int kBoxBytes = BK * 64 * 2;        // one 64 x 64 box of B

// shared memory: the operand ring, the bf16 output tile staged for the
// bulk stores (rows padded by 16 bytes: conflict-free writes; not where K
// is split, whose epilogue reduces in the ring), the ring's mbarriers
template <int BN, bool kSplit>
struct Tile {
  static constexpr int kStages = BN == 256 && !kSplit ? 3 : 4;
  static constexpr int kStageBytes = kABytes + BK * BN * 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kOutStride = BN * 2 + 16;
  static constexpr int kOutBytes = kSplit ? 0 : BM * kOutStride;
  static constexpr int kSmemBytes =
      kRingBytes + kOutBytes + 2 * kStages * 8 + 1024;   // + 1 KB alignment
  static constexpr int kRedStride = BN + 8;   // float32 partial rows
  static_assert(BM * kRedStride * 4 <= kRingBytes, "partials fit the ring");
  static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");
};

using namespace fvp;

// the two consumer warpgroups only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  named_sync(1, kConsumers);
}

// one warpgroup (named barriers 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  named_sync(2 + wg, 128);
}

template <int BN, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
deconv_stage_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ aff,
                    __nv_bfloat16* __restrict__ y, int H, int W, int F,
                    int tw, int tiles_h, int tiles_w, int mtiles,
                    int kb_per_tap, int splits) {
  using T = Tile<BN, kSplit>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // 128B-swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  constexpr int kStages = T::kStages;
  unsigned char* staged = smem + T::kRingBytes;    // the bf16 output tile
  const uint32_t full0 = base + T::kRingBytes + T::kOutBytes;
  const uint32_t empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x;
  const int th = BM / tw, ntiles = F / BN, kb_total = 4 * kb_per_tap;
  const int items = 4 * ntiles * mtiles * splits;

  // work item -> (parity, N tile, M tile, rank along K): the rank is
  // fastest (a cluster's CTAs are consecutive blocks), then the M tile, so
  // that the CTAs running together share a parity's weights in L2
  struct Item {
    int p, n0, view, h0, w0, kb0, nkb, rank;
  };
  auto decode = [&](int item) {
    Item it;
    it.rank = item % splits;
    int rest = item / splits;
    const int mt = rest % mtiles;
    rest /= mtiles;
    it.n0 = (rest % ntiles) * BN;
    it.p = rest / ntiles;
    const int per_view = tiles_h * tiles_w, rem = mt % per_view;
    it.view = mt / per_view;
    it.h0 = (rem / tiles_w) * th;
    it.w0 = (rem % tiles_w) * tw;
    it.kb0 = it.rank * kb_total / splits;
    it.nkb = (it.rank + 1) * kb_total / splits - it.kb0;
    return it;
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring full, across the
    // work items of this CTA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == kConsumers) {
      int g = 0;                       // ring position
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item it = decode(item);
        const int r = it.p >> 1, s = it.p & 1;
        for (int i = 0; i < it.nkb; ++i, ++g) {
          const int st = g % kStages;
          if (g >= kStages)
            mbar_wait(empty0 + 8 * st, ((g / kStages) & 1) ^ 1);
          const int kb = it.kb0 + i, t = kb / kb_per_tap;
          const int c0 = (kb % kb_per_tap) * BK, u = t >> 1, v = t & 1;
          const uint32_t full = full0 + 8 * st;
          const uint32_t a = base + st * T::kStageBytes, b = a + kABytes;
          mbar_expect_tx(full, T::kStageBytes);
          tma_load_4d(a, &tm_x, full, c0, it.w0 + v - s, it.h0 + u - r,
                      it.view);
          const int krow = (4 * it.p + t) * (kb_per_tap * BK) + c0;
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(b + c * kBoxBytes, &tm_w, full, it.n0 + 64 * c, krow);
        }
      }
    }
    if (kSplit) {                      // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ---- consumer warpgroups: rows 64*wg .. 64*wg+63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
    // d[4j + 2h + e] is row 16*(warp%4) + lane/4 + 8h of this warpgroup's
    // 64, column 8j + 2*(lane%4) + e
    const int q = lane & 3;
    const int row0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    int g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = decode(item);
      const int r = it.p >> 1, s = it.p & 1, n0 = it.n0;
      float d[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

      for (int i = 0; i < it.nkb; ++i, ++g) {
        const int st = g % kStages;
        mbar_wait(full0 + 8 * st, (g / kStages) & 1);
        const uint32_t a = base + st * T::kStageBytes + wg * (64 * BK * 2);
        const uint32_t b = base + st * T::kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          // A: +32 bytes per 16 channels inside the swizzled 128-byte
          // rows; B: +2 KB per 16 k rows (two 8-row swizzle atoms), the
          // next 64 columns one box (8 KB, the LBO) on
          Wgmma<BN>::mma(d, smem_desc(a + 32 * k, 16, 1024, 128),
                         smem_desc(b + 2048 * k, kBoxBytes, 1024, 128));
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();             // the previous stage is read: free it
          if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % kStages));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % kStages));

      // output offset (elements) of tile row `row`, or -1 outside the image
      auto out_base = [&](int row) -> long long {
        const int hl = row / tw, hi = it.h0 + hl;
        const int wi = it.w0 + (row - hl * tw);
        if (hi >= H || wi >= W) return -1;
        return (((long long)it.view * 2 * H + 2 * hi + 1 - r) * 2 * W +
                2 * wi + 1 - s) * F + n0;
      };

      if (!kSplit) {
        // ---- epilogue, each warpgroup on its own 64 rows (one may start
        // the next item's products while the other finishes): affine, ReLU
        // and bf16 from the accumulators into the staged tile (stmatrix),
        // then one bulk store per output pixel (BN channels), left in
        // flight while the next item runs ----
        const int wtid = tid & 127;
        if (wtid < 64) bulk_wait<false>();  // its last row has left
        warpgroup_sync(wg);
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          uint32_t v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            // matrix m: columns 8(j + m/2).., rows +8 * (m % 2)
            const int jj = j + (m >> 1), hh = m & 1;
            const int c = n0 + 8 * jj + 2 * q;
            const float2 sc = __ldg(reinterpret_cast<const float2*>(aff + c));
            const float2 sh =
                __ldg(reinterpret_cast<const float2*>(aff + F + c));
            v[m] = pack2(fmaxf(d[4 * jj + 2 * hh] * sc.x + sh.x, 0.f),
                         fmaxf(d[4 * jj + 2 * hh + 1] * sc.y + sh.y, 0.f));
          }
          // lane l gives the address of row l % 8 of matrix l / 8
          const int m = lane >> 3;
          const int row = 64 * wg + 16 * (warp & 3) + (lane & 7) + 8 * (m & 1);
          stmatrix_x4(smem_u32(staged + row * T::kOutStride +
                               2 * 8 * (j + (m >> 1))),
                      v);
        }
        // the generic-proxy writes, visible to the bulk copies
        fence_proxy_async();
        warpgroup_sync(wg);
        if (wtid < 64) {
          const int row = 64 * wg + wtid;
          const long long ob = out_base(row);
          if (ob >= 0)
            bulk_store(y + ob, smem_u32(staged + row * T::kOutStride),
                       BN * 2);
        }
      } else {
        // ---- split K (one item per CTA): every rank leaves its float32
        // partial tile in its drained ring; rank q then sums rows
        // [q, q+1) * 128/splits over the ranks in rank order through
        // distributed shared memory, and applies the epilogue to them ----
        constexpr int RS = T::kRedStride;
        float* red = reinterpret_cast<float*>(smem);
        consumers_sync();              // both warpgroups are done with the ring
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<float2*>(red + (row0 + 8 * hh) * RS + 8 * j +
                                       2 * q) =
                make_float2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
        cluster_sync();
        const int rows = BM / splits, chunks = BN / 8;
        for (int e = tid; e < rows * chunks; e += kConsumers) {
          const int row = it.rank * rows + e / chunks, c = 8 * (e % chunks);
          const uint32_t local = smem_u32(red + row * RS + c);
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int src = 0; src < splits; ++src) {
            const uint32_t peer = peer_addr(local, src);
            const float4 lo = ld_cluster_f4(peer);
            const float4 hi = ld_cluster_f4(peer + 16);
            v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
            v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
          }
          const long long ob = out_base(row);
          if (ob >= 0) {
            const float4* sc = reinterpret_cast<const float4*>(aff + n0 + c);
            const float4* sh =
                reinterpret_cast<const float4*>(aff + F + n0 + c);
            const float4 a0 = __ldg(sc), a1 = __ldg(sc + 1);
            const float4 b0 = __ldg(sh), b1 = __ldg(sh + 1);
            *reinterpret_cast<uint4*>(y + ob + c) = make_uint4(
                pack2(fmaxf(v[0] * a0.x + b0.x, 0.f),
                      fmaxf(v[1] * a0.y + b0.y, 0.f)),
                pack2(fmaxf(v[2] * a0.z + b0.z, 0.f),
                      fmaxf(v[3] * a0.w + b0.w, 0.f)),
                pack2(fmaxf(v[4] * a1.x + b1.x, 0.f),
                      fmaxf(v[5] * a1.y + b1.y, 0.f)),
                pack2(fmaxf(v[6] * a1.z + b1.z, 0.f),
                      fmaxf(v[7] * a1.w + b1.w, 0.f)));
          }
        }
        cluster_sync();                // peers keep their memory until here
      }
    }
    if ((tid & 127) < 64) bulk_wait<true>();
  }
}

template <int BN, bool kSplit>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                   const float* aff, void* y, int V, int H, int W, int Cin,
                   int F, int th, int tw, int splits, int ctas,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        deconv_stage_kernel<BN, kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN, kSplit>::kSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int tiles_h = (H + th - 1) / th, tiles_w = (W + tw - 1) / tw;
  const int mtiles = V * tiles_h * tiles_w;
  const int items = 4 * (F / BN) * mtiles * splits;
  // one CTA per item where K is split (a cluster per tile), else at most
  // `ctas` persistent CTAs walking the items
  if (ctas < 1 || ctas > items || (splits > 1 && ctas != items))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<BN, kSplit>::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, deconv_stage_kernel<BN, kSplit>, tm_x,
                            tm_w, aff,
                            static_cast<__nv_bfloat16*>(y), H, W, F, tw,
                            tiles_h, tiles_w, mtiles, Cin / BK, splits);
}

}  // namespace

// x (V, H, W, Cin) bf16; w (4 parities, 4 taps, Cin, F) bf16; aff (2, F)
// float32 (scale, shift); y (V, 2H, 2W, F) bf16. The tiling comes from
// deconv_plan: a th x tw source patch (th * tw = 128) by bn = 128 or 256
// output channels, `splits` (1, 2, 4 or 8) CTAs along K in one cluster,
// and `ctas` CTAs (one per tile and rank where K is split, else at most one
// per SM). Cin % 64 == 0, F % bn == 0; x, w and aff 16-byte aligned.
FVP_API int fvp_deconv_stage(const void* x, const void* w, const float* aff,
                             void* y, int V, int H, int W, int Cin, int F,
                             int th, int tw, int splits, int bn, int ctas,
                             void* stream) {
  if (Cin % BK || (bn != 128 && bn != 256) || F % bn || V <= 0 || H <= 0 ||
      W <= 0 || tw <= 0 || th * tw != BM || tw > 256 || th > 256 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      4 * (Cin / BK) < splits)
    return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = fvp::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)V};
  const cuuint64_t xstr[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                              (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)tw, (cuuint32_t)th, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  // zero fill outside x (FLOAT_OOB_FILL_NONE): the SAME padding
  if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             xdim, xstr, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)F, (cuuint64_t)16 * Cin};
  const cuuint64_t wstr[1] = {(cuuint64_t)F * 2};
  const cuuint32_t wbox[2] = {64, BK};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             wdim, wstr, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      bn == 256 ? (splits > 1 ? launch<256, true> : launch<256, false>)(
                      tm_x, tm_w, aff, y, V, H, W, Cin, F, th, tw, splits,
                      ctas, st)
                : (splits > 1 ? launch<128, true> : launch<128, false>)(
                      tm_x, tm_w, aff, y, V, H, W, Cin, F, th, tw, splits,
                      ctas, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Hopper building blocks shared by the port's TMA + wgmma kernels
// (csrc/deconv_head.cu, csrc/conv_bf16.cu): mbarriers, TMA tensor loads,
// bulk stores and L2 prefetches, wgmma (m64nNk16, bf16 operands, float32 sums) with its
// shared-memory descriptors for the 32-, 64- and 128-byte swizzles, the
// cluster's distributed shared memory, and cuTensorMapEncodeTiled through
// the runtime's driver entry point (no -lcuda).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fvp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

// waits for the phase of `parity` to complete; a wait that never ends (a
// fault in a kernel's barrier arithmetic) traps after ~2 s, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 1; !done; ++polls) {
    if ((polls & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 2000000000ull)
        __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// bulk copy of `bytes` (a multiple of 16) from shared to global memory
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// asks L2 to fetch `bytes` (a multiple of 16) of global memory at `p`
// (16-byte aligned), without waiting
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// the source of this thread's bulk stores has been read (or, with
// `done`, the stores have completed)
template <bool done>
__device__ __forceinline__ void bulk_wait() {
  if (done)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the generic-proxy writes to shared memory, visible to bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` (1..15) over `count` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// four 8 x 8 bf16 matrices from the mma accumulator layout (lane l: row
// l / 4, columns 2 * (l % 4)) to shared memory, lane l addressing row
// l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&v)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
          addr),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
      : "memory");
}

// wgmma shared-memory descriptor of an operand that TMA stored with a
// `swizzle`-byte swizzle (128, 64 or 32: layout types 1, 2, 3). An atom is
// 8 rows of `swizzle` bytes. K-major: the start steps 32 bytes per k16
// inside a row, SBO is the next 8 rows (8 * swizzle), LBO is unused.
// MN-major (through the transpose bit): LBO is the next atom along MN, SBO
// the next 8 rows along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define FVP_D8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D(64 x N, float32) += A(64 x 16, K-major) . B(16 x N, MN-major); thread
// t of the warpgroup holds d[4j + 2h + e] = row 16 (t / 32) + (t % 32) / 4
// + 8h, column 8j + 2 (t % 4) + e
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 1;\n}"
        : FVP_D8(0)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}"
        : FVP_D8(0), FVP_D8(8)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}"
        : FVP_D8(0), FVP_D8(8), FVP_D8(16), FVP_D8(24)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
        "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}"
        : FVP_D8(0), FVP_D8(8), FVP_D8(16), FVP_D8(24), FVP_D8(32), FVP_D8(40),
        FVP_D8(48), FVP_D8(56)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
        "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
        "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
        "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
        "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
        "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}"
        : FVP_D8(0), FVP_D8(8), FVP_D8(16), FVP_D8(24), FVP_D8(32), FVP_D8(40),
        FVP_D8(48), FVP_D8(56), FVP_D8(64), FVP_D8(72), FVP_D8(80), FVP_D8(88),
        FVP_D8(96), FVP_D8(104), FVP_D8(112), FVP_D8(120)
        : "l"(da), "l"(db), "r"(1));
  }
};

#undef FVP_D8

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (so
// the library needs no -lcuda); nullptr where the driver lacks it
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// the tensor map swizzle of a box whose inner dimension is `bytes` wide
inline CUtensorMapSwizzle tma_swizzle(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

}  // namespace fvp

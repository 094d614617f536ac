// K2 person_planes: per-person cube sampling and tri-plane max-collapse in
// one kernel, on heatmaps laid out pixel-major by a transpose kernel.
//
// Replaces fvp_tpu/ops/pallas/sampler.py::pallas_tiled_sample_project
// (in-kernel projection + tiled hat-function matmul sampling) together with
// fvp_tpu/ops/pallas/collapse.py::collapse_planes_pallas (masked max onto
// the xy / xz / yz planes), the two launches of
// fast_sampling.py::sample_person_planes_pallas_batched. Row 4 of the TPU
// table (pallas_tiled_sample_project_collapse) fused the same two steps.
//
// What it computes, per person p (item b = p / K) and cube voxel (x, y, z):
// the world position origin + (corner + (x, y, z)) * pitch, its projection
// through every view (project_points_uv with distortion, then
// to_sample_px_uv's clamp chain), a bilinear sample of every joint's map,
// the view mean clamped to [0, 1], and then the maxima over z (xy plane),
// over y (xz plane) and over x (yz plane). Voxels outside the person's
// [start, end) crop take no part; a person that takes no part (dead, or
// not matched) passes end == start and gets zero planes.
//
// Bound on the H100: the gathers. The cube it never writes would be
// (10, 64^3, 15) floats, 157 MB; the planes are 7.4 MB, so it is far from
// the HBM bound, and every one of the 10 * 64^3 * V voxel projections
// feeds J * 4 gathers from the L2-resident heatmaps. PR 1's kernel read
// them as scalars from (B, V, J, H, W) maps, one 32-byte sector per joint
// and corner: with the gathers switched off it ran in 0.41 of its 2.04 ms
// (fvp_torch/tools/kernel_parts.py, NVIDIA H100 80GB HBM3, 700 W),
// with the projection off 0.44, with plain stores for its atomics 2.16.
// Design:
// - `person_layout_kernel` writes the heatmaps once per frame pixel-major,
//   (B, V, H, W, JP) with the joints padded to JP = 16 (J = 15) or 20
//   (J = 17) with zeros, so a bilinear tap is JP / 4 16-byte loads from
//   one 64- or 80-byte span and the x0 and x0 + 1 taps lie side by side:
//   2-3 sectors per tap for all joints in place of J;
// - a block is a (person, 16-x slab, TY-y rows) tile with one thread per
//   (y, z) looping over the slab's x, so
//   * yz (max over x) runs in registers and leaves by one global atomicMax
//     per (y, z, joint) and block;
//   * xy (max over z) is a warp-shuffle max (z runs across lanes), stored
//     once since a block holds every z of its (x, y);
//   * xz (max over y) collects in shared memory and leaves by one global
//     atomicMax per (x, z, joint) and block;
// - the projection rounds every multiply, add and divide on its own
//   (__fmul_rn, __fadd_rn, __fdiv_rn are never contracted), in the plain
//   version's order, so the coordinates -- and floorf's taps -- match it
//   to the bit; the bilinear sums may contract into FMAs.
// Measured (fvp_torch/tools/kernel_parts.py, 10 full 64^3 cubes, NVIDIA
// H100 80GB HBM3, 700 W): 0.8330 ms (PR 1's kernel 2.0412); with the
// gathers switched off 0.3116, with constant coordinates 0.3617, with
// plain stores for the atomics 0.8186: the gathers still lead, now from
// L2 at ~5.9 TB/s of the 64-byte records' requested bytes.
// All values lie in [0, 1]: non-negative floats order like their int bit
// patterns, so atomicMax on the int view is exact and order-independent,
// and planes that start at 0 and skip invalid voxels equal the plain
// "multiply by validity, then max". The wrapper zero-fills the planes.

#include "common.cuh"

namespace {

constexpr int kTX = 16;  // x values per block (looped in each thread)

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// (B, V, J, H, W) -> (B, V, H, W, JP), joints J..JP-1 zero: one thread per
// pixel, reading each joint's plane coalesced along w and writing its JP
// floats as JP / 4 16-byte stores.
__global__ void person_layout_kernel(const float* __restrict__ hm,
                                     float* __restrict__ out, int BV, int J,
                                     int HW, int JP) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)BV * HW) return;
  const long long bv = i / HW, pix = i - bv * HW;
  const float* src = hm + bv * J * HW + pix;
  float4* dst = reinterpret_cast<float4*>(out + i * JP);
  for (int q = 0; q < JP / 4; ++q) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * q + e;
      v[e] = j < J ? __ldg(src + (long long)j * HW) : 0.f;
    }
    dst[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int JT>
__global__ void __launch_bounds__(512)
person_planes_kernel(const float* __restrict__ hmp,
                     const float* __restrict__ cams,
                     const int* __restrict__ corner,
                     const int* __restrict__ start,
                     const int* __restrict__ end, float* __restrict__ planes,
                     int V, int H, int W, int NC, int K, int P, float pitch_x,
                     float pitch_y, float pitch_z, float origin_x,
                     float origin_y, float origin_z, float bound) {
  constexpr int JP = (JT + 3) / 4 * 4;
  constexpr int NQ = JP / 4;
  extern __shared__ int smem[];
  const int p = blockIdx.z;
  const int TY = blockDim.y;
  const int z = threadIdx.x;                       // blockDim.x == NC
  const int ty = threadIdx.y;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * TY;
  const int y = y0 + ty;

  const int cx = corner[3 * p], cy = corner[3 * p + 1], cz = corner[3 * p + 2];
  // cube-local valid range [lo, hi) per axis
  const int lox = start[3 * p] - cx, hix = end[3 * p] - cx;
  const int loy = start[3 * p + 1] - cy, hiy = end[3 * p + 1] - cy;
  const int loz = start[3 * p + 2] - cz, hiz = end[3 * p + 2] - cz;
  // block-uniform exits: nothing of this tile takes part
  if (lox >= hix || loy >= hiy || loz >= hiz) return;
  if (x0 + kTX <= lox || x0 >= hix || y0 + TY <= loy || y0 >= hiy) return;

  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + z;
  int* xy_s = smem;                                // (kTX, TY, JT)
  int* xz_s = smem + kTX * TY * JT;                // (kTX, NC, JT)
  for (int i = tid; i < kTX * (TY + NC) * JT; i += nthreads) smem[i] = 0;
  __syncthreads();

  const bool yz_ok = y >= loy && y < hiy && z >= loz && z < hiz;
  const float wy = add(origin_y, mul((float)(cy + y), pitch_y));
  const float wz = add(origin_z, mul((float)(cz + z), pitch_z));
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const long long plane = (long long)H * W;
  const float4* hmb =
      reinterpret_cast<const float4*>(hmp) + (long long)(p / K) * V * plane * NQ;
  const int seg = NC < 32 ? NC : 32;               // lanes sharing one (x, y)

  float yzmax[JT];
#pragma unroll
  for (int j = 0; j < JT; ++j) yzmax[j] = 0.f;

  for (int xi = 0; xi < kTX; ++xi) {
    const int x = x0 + xi;
    const bool ok = yz_ok && x >= lox && x < hix;
    float val[JP];
#pragma unroll
    for (int j = 0; j < JP; ++j) val[j] = 0.f;
    if (ok) {
      const float wx = add(origin_x, mul((float)(cx + x), pitch_x));
      for (int v = 0; v < V; ++v) {
        const float* c = cams + 27 * v;
        const float dx = sub(wx, c[9]), dy = sub(wy, c[10]),
                    dz = sub(wz, c[11]);
        const float xc = add(add(mul(c[0], dx), mul(c[1], dy)), mul(c[2], dz));
        const float yc = add(add(mul(c[3], dx), mul(c[4], dy)), mul(c[5], dz));
        const float zc = add(
            add(add(mul(c[6], dx), mul(c[7], dy)), mul(c[8], dz)), 1e-5f);
        const float yx = __fdiv_rn(xc, zc), yy = __fdiv_rn(yc, zc);
        const float r2 = add(mul(yx, yx), mul(yy, yy));
        const float d =
            add(1.f, mul(r2, add(c[16], mul(r2, add(c[17], mul(r2, c[18]))))));
        float u = add(add(mul(yx, d), mul(mul(mul(2.f, c[19]), yx), yy)),
                      mul(c[20], add(r2, mul(mul(2.f, yx), yx))));
        float w = add(add(mul(yy, d), mul(mul(mul(2.f, c[20]), yx), yy)),
                      mul(c[19], add(r2, mul(mul(2.f, yy), yy))));
        u = fvp::clampf(add(mul(c[12], u), c[14]), -1.f, bound);
        w = fvp::clampf(add(mul(c[13], w), c[15]), -1.f, bound);
        const float hx = add(add(mul(c[21], u), mul(c[22], w)), c[23]);
        const float hy = add(add(mul(c[24], u), mul(c[25], w)), c[26]);
        const float gx =
            fvp::clampf(sub(mul(__fdiv_rn(hx, wm1), 2.f), 1.f), -1.1f, 1.1f);
        const float gy =
            fvp::clampf(sub(mul(__fdiv_rn(hy, hm1), 2.f), 1.f), -1.1f, 1.1f);
        const float sx = mul(mul(add(gx, 1.f), 0.5f), wm1);
        const float sy = mul(mul(add(gy, 1.f), 0.5f), hm1);

        const float fx0 = floorf(sx), fy0 = floorf(sy);
        const float ax = sx - fx0, ay = sy - fy0;
        const int ix = (int)fx0, iy = (int)fy0;
        const bool vx0 = ix >= 0 && ix < W, vx1 = ix + 1 >= 0 && ix + 1 < W;
        const bool vy0 = iy >= 0 && iy < H, vy1 = iy + 1 >= 0 && iy + 1 < H;
        const float w00 = (vx0 && vy0) ? (1.f - ax) * (1.f - ay) : 0.f;
        const float w10 = (vx1 && vy0) ? ax * (1.f - ay) : 0.f;
        const float w01 = (vx0 && vy1) ? (1.f - ax) * ay : 0.f;
        const float w11 = (vx1 && vy1) ? ax * ay : 0.f;
        const int cx0 = min(max(ix, 0), W - 1), cx1 = min(max(ix + 1, 0), W - 1);
        const int cy0 = min(max(iy, 0), H - 1), cy1 = min(max(iy + 1, 0), H - 1);
        const float4* hv = hmb + (long long)v * plane * NQ;
        const float4* p00 = hv + (cy0 * W + cx0) * NQ;
        const float4* p10 = hv + (cy0 * W + cx1) * NQ;
        const float4* p01 = hv + (cy1 * W + cx0) * NQ;
        const float4* p11 = hv + (cy1 * W + cx1) * NQ;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 a = __ldg(p00 + q), b = __ldg(p10 + q),
                       e = __ldg(p01 + q), f = __ldg(p11 + q);
          val[4 * q + 0] += a.x * w00 + b.x * w10 + e.x * w01 + f.x * w11;
          val[4 * q + 1] += a.y * w00 + b.y * w10 + e.y * w01 + f.y * w11;
          val[4 * q + 2] += a.z * w00 + b.z * w10 + e.z * w01 + f.z * w11;
          val[4 * q + 3] += a.w * w00 + b.w * w10 + e.w * w01 + f.w * w11;
        }
      }
#pragma unroll
      for (int j = 0; j < JT; ++j)
        val[j] = fvp::clampf(val[j] / (float)V, 0.f, 1.f);
    }

#pragma unroll
    for (int j = 0; j < JT; ++j) {
      yzmax[j] = fmaxf(yzmax[j], val[j]);
      if (val[j] > 0.f)
        atomicMax(&xz_s[(xi * NC + z) * JT + j], __float_as_int(val[j]));
      float m = val[j];
      for (int off = seg / 2; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off, seg));
      if ((z % seg) == 0 && m > 0.f)
        atomicMax(&xy_s[(xi * TY + ty) * JT + j], __float_as_int(m));
    }
  }
  __syncthreads();

  const long long PN = (long long)P * NC * NC * JT;   // one plane stack
  int* xz_g = reinterpret_cast<int*>(planes + PN);
  int* yz_g = reinterpret_cast<int*>(planes + 2 * PN);
  const long long pbase = (long long)p * NC * NC * JT;
  // xy: this block holds every z of its (x, y): plain stores
  for (int i = tid; i < kTX * TY * JT; i += nthreads) {
    const int xi = i / (TY * JT), r = i % (TY * JT);
    const int yy = y0 + r / JT, j = r % JT;
    planes[pbase + ((long long)(x0 + xi) * NC + yy) * JT + j] =
        __int_as_float(xy_s[i]);
  }
  for (int i = tid; i < kTX * NC * JT; i += nthreads) {
    const int v = xz_s[i];
    if (v > 0) {
      const int xi = i / (NC * JT), r = i % (NC * JT);
      atomicMax(&xz_g[pbase + (long long)(x0 + xi) * NC * JT + r], v);
    }
  }
#pragma unroll
  for (int j = 0; j < JT; ++j)
    if (yzmax[j] > 0.f)
      atomicMax(&yz_g[pbase + ((long long)y * NC + z) * JT + j],
                __float_as_int(yzmax[j]));
}

template <int JT>
int launch(const float* hmp, const float* cams, const int* corner,
           const int* start, const int* end, float* planes, int V, int H,
           int W, int NC, int TY, int K, int P, float pitch_x, float pitch_y,
           float pitch_z, float origin_x, float origin_y, float origin_z,
           float bound, cudaStream_t stream) {
  const size_t smem = sizeof(int) * kTX * (TY + NC) * JT;
  cudaError_t err = cudaFuncSetAttribute(
      person_planes_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(NC, TY);
  const dim3 grid(NC / kTX, NC / TY, P);
  person_planes_kernel<JT><<<grid, block, smem, stream>>>(
      hmp, cams, corner, start, end, planes, V, H, W, NC, K, P, pitch_x,
      pitch_y, pitch_z, origin_x, origin_y, origin_z, bound);
  return (int)cudaGetLastError();
}

}  // namespace

// hm (B, V, J, H, W) -> out (B, V, H, W, JP), JP = J rounded up to 4, the
// padding zero.
FVP_API int fvp_person_layout(const float* hm, float* out, int BV, int J,
                              int H, int W, int JP, void* stream) {
  const long long n = (long long)BV * H * W;
  const int threads = 256;
  person_layout_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(hm, out, BV, J, H * W, JP);
  return (int)cudaGetLastError();
}

// hmp (B, V, H, W, JP) from fvp_person_layout; cams (V, 27);
// corner/start/end (P, 3) int32; planes (3, P, NC, NC, J) zero-filled.
// NC a power of two in [16, 64], TY (y rows per block) from the wrapper's
// tiling (ops/kernels/sampler.py::person_tiling); J in {15, 17} (the joint
// sets of the repo's configs).
FVP_API int fvp_person_planes(const float* hmp, const float* cams,
                              const int* corner, const int* start,
                              const int* end, float* planes, int V, int J,
                              int H, int W, int NC, int TY, int K, int P,
                              float pitch_x, float pitch_y, float pitch_z,
                              float origin_x, float origin_y, float origin_z,
                              float bound, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (J == 15)
    return launch<15>(hmp, cams, corner, start, end, planes, V, H, W, NC, TY,
                      K, P, pitch_x, pitch_y, pitch_z, origin_x, origin_y,
                      origin_z, bound, s);
  if (J == 17)
    return launch<17>(hmp, cams, corner, start, end, planes, V, H, W, NC, TY,
                      K, P, pitch_x, pitch_y, pitch_z, origin_x, origin_y,
                      origin_z, bound, s);
  return (int)cudaErrorInvalidValue;
}

// c2cnet: all of C2CNet, the HDN's 1D hourglass over the proposals'
// z-columns, in one launch: (N, Z, J) float32 columns -> (N, Z) float32.
//
// Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_c2cnet (`_c2c_kernel`),
// which runs the net for all columns in one grid step with the items on
// the sublanes. The net does ~2.5e6 multiply-adds per column (5e7
// operations for 10 columns at Z = 20) on 0.76 MB of bf16 weights: its time
// is bound by launch and latency, not by operations or bytes, and its
// yardstick is the ~25 launches of the cuDNN module. Design: one block of
// 1024 threads per column. Every level's activations (at most Z x 32
// values: 32 channels at Z, 64 at Z/2, 128 at Z/4) live in shared memory
// as float32 holding the bf16-rounded values. Each layer's bf16 weights
// (at most 96 KB) are first copied from L2 into shared memory with 16-byte
// loads, so the multiply-adds read shared memory only: the activation value
// is one broadcast per warp, the weights a thread's output channel on
// consecutive addresses across the warp. A thread computes a whole output
// (z, f), or, where a layer has fewer outputs than threads, a slice of its
// input channels, the slices summed in a fixed order after a barrier.
//
// Numerics (the TPU kernel's): the input rounds to bf16; the front conv and
// each ResBlock's first conv round relu(aff(conv)); a projection skip stays
// float32; the join relu(aff(conv) + skip) rounds; an up-conv rounds
// relu(aff(.)), adds the bf16 skip and rounds again; the 1x1 output conv
// adds its bias in float32.
//
// The layers are walked in the order of ops/kernels/c2cnet.py::layer_shapes
// through two flat buffers: weights (taps, Cin, F) bf16 and affines (2, F)
// float32 (scale, shift), one after the other.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 1024;
constexpr int C0 = 32, C1 = 64, C2 = 128, CF = 16;  // models/blocks.py widths

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Net {
  const bf16* w;      // the next layer's weights in the flat buffer
  const float* aff;   // and its affine
  bf16* wsm;          // shared memory for one layer's weights
  float* part;        // shared memory for split sums (kThreads floats)
};

// copy n bf16 weights of the layer into shared memory
__device__ void stage(bf16* dst, const bf16* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % 8 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n / 8; i += blockDim.x) d[i] = __ldg(s + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// One layer, starting with a barrier (its input and its shared scratch are
// then ready). A conv (up == false): out[z, f] = aff(sum_{t, c}
// in[z + t - k/2, c] w[t, c, f]) (+ res[z, f]) (ReLU) (rounded to bf16),
// `in` (Z, Cin), `out` and `res` (Z, F). An up-conv (k = 2, stride 2):
// out[2z + r, f] = bf16(bf16(relu(aff(in[z] . w[r, :, f]))) + res[2z + r,
// f]), `in` (Z, Cin), `out` and `res` (2Z, F).
__device__ void layer(Net& net, const float* in, int Z, int Cin, int k,
                      int F, bool up, float* out, const float* res, bool relu,
                      bool rnd) {
  __syncthreads();
  stage(net.wsm, net.w, k * Cin * F);
  __syncthreads();
  const bf16* w = net.wsm;
  const float* aff = net.aff;
  const int n_out = (up ? 2 * Z : Z) * F;
  // split the input channels over S threads where outputs are few; then
  // n_out * S <= kThreads, the size of net.part
  const int S = max(1, min(min((int)blockDim.x / n_out, Cin), 8));
  const int pad = k / 2;
  auto finish = [&](int o, float acc) {
    const int f = o % F;
    float v = acc * aff[f] + aff[F + f];
    if (up) {
      out[o] = round_bf16(round_bf16(fmaxf(v, 0.f)) + res[o]);
      return;
    }
    if (res) v += res[o];
    if (relu) v = fmaxf(v, 0.f);
    out[o] = rnd ? round_bf16(v) : v;
  };
  for (int item = threadIdx.x; item < n_out * S; item += blockDim.x) {
    const int s = item / n_out, o = item - s * n_out;
    const int zo = o / F, f = o - zo * F;
    const int c0 = s * Cin / S, c1 = (s + 1) * Cin / S;
    float acc = 0.f;
    for (int t = 0; t < (up ? 1 : k); ++t) {
      const int zz = up ? zo >> 1 : zo + t - pad;
      const int tap = up ? zo & 1 : t;
      if (zz < 0 || zz >= Z) continue;
      const float* xr = in + zz * Cin;
      const bf16* wr = w + tap * Cin * F + f;
#pragma unroll 4
      for (int c = c0; c < c1; ++c)
        acc = fmaf(xr[c], __bfloat162float(wr[c * F]), acc);
    }
    if (S == 1)
      finish(o, acc);
    else
      net.part[item] = acc;
  }
  if (S > 1) {                          // S is the same for every thread
    __syncthreads();
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      float acc = net.part[o];
      for (int s = 1; s < S; ++s) acc += net.part[s * n_out + o];
      finish(o, acc);
    }
  }
  net.w += (long long)k * Cin * F;
  net.aff += 2 * F;
}

__device__ void conv(Net& net, const float* in, int Z, int Cin, int k, int F,
                     float* out, const float* res, bool relu, bool rnd) {
  layer(net, in, Z, Cin, k, F, false, out, res, relu, rnd);
}

__device__ void upconv(Net& net, const float* in, int Z, int Cin, int F,
                       float* out, const float* skip) {
  layer(net, in, Z, Cin, 2, F, true, out, skip, true, true);
}

__device__ void pool(const float* in, int Z, int C, float* out) {
  __syncthreads();
  for (int o = threadIdx.x; o < (Z / 2) * C; o += blockDim.x) {
    const int z = o / C, c = o - z * C;
    out[o] = fmaxf(in[2 * z * C + c], in[(2 * z + 1) * C + c]);
  }
}

// ResBlock: out = bf16(relu(aff(conv3(h)) + skip)), h = bf16(relu(aff(
// conv3(x)))), skip = aff(conv1(x)) (float32) if Cin != F, else x. `h` and
// `p` are scratch. The flat buffer holds c0, c1, proj in that order.
__device__ void resblock(Net& net, const float* x, int Z, int Cin, int F,
                         float* out, float* h, float* p) {
  conv(net, x, Z, Cin, 3, F, h, nullptr, true, true);        // c0
  Net c1 = net;                        // c1 runs after the projection
  net.w += 3LL * F * F;
  net.aff += 2 * F;
  const float* skip = x;
  if (Cin != F) {                                            // proj
    conv(net, x, Z, Cin, 1, F, p, nullptr, false, false);
    skip = p;
  }
  conv(c1, h, Z, F, 3, F, out, skip, true, true);
}

__global__ void __launch_bounds__(kThreads)
c2cnet_kernel(const float* __restrict__ cols, const bf16* __restrict__ w,
              const float* __restrict__ aff, float* __restrict__ out, int Z,
              int J) {
  extern __shared__ __align__(16) float sm[];
  const int L = C0 * Z;                 // the largest activation of a level
  float* part = sm;                     // kThreads
  float* A = part + kThreads;
  float* B = A + L;
  float* H = B + L;
  float* P = H + L;
  float* S1 = P + L;
  float* S2 = S1 + L;
  float* in = S2 + L;                   // (Z, J)
  bf16* wsm = reinterpret_cast<bf16*>(in + ((J * Z + 3) & ~3));
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < Z * J; i += blockDim.x)
    in[i] = round_bf16(cols[(long long)n * Z * J + i]);

  Net net{w, aff, wsm, part};
  const int Z1 = Z / 2, Z2 = Z / 4;
  conv(net, in, Z, J, 7, CF, A, nullptr, true, true);        // front
  resblock(net, A, Z, CF, C0, B, H, P);                     // res0
  resblock(net, B, Z, C0, C0, S1, H, P);                    // skip_res1
  pool(B, Z, C0, A);
  resblock(net, A, Z1, C0, C1, B, H, P);                    // encoder_res1
  resblock(net, B, Z1, C1, C1, S2, H, P);                   // skip_res2
  pool(B, Z1, C1, A);
  resblock(net, A, Z2, C1, C2, B, H, P);                    // encoder_res2
  resblock(net, B, Z2, C2, C2, A, H, P);                    // mid_res
  resblock(net, A, Z2, C2, C2, B, H, P);                    // decoder_res2
  upconv(net, B, Z2, C2, C1, A, S2);                        // upsample2
  resblock(net, A, Z1, C1, C1, B, H, P);                    // decoder_res1
  upconv(net, B, Z1, C1, C0, A, S1);                        // upsample1
  __syncthreads();
  // final 1x1 conv C0 -> 1 with its bias, float32 out
  for (int z = threadIdx.x; z < Z; z += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C0; ++c)
      acc = fmaf(A[z * C0 + c], __bfloat162float(net.w[c]), acc);
    out[(long long)n * Z + z] = acc * net.aff[0] + net.aff[1];
  }
}

// shared memory of a block: the float32 buffers, then one layer's weights
size_t smem_bytes(int Z, int J) {
  const int big = 3 * C2 * C2;         // the largest conv: 128 -> 128
  const int wmax = 7 * J * CF > big ? 7 * J * CF : big;
  return sizeof(float) * (kThreads + 6 * (size_t)C0 * Z +
                          (((size_t)J * Z + 3) & ~(size_t)3)) +
         sizeof(bf16) * (size_t)wmax;
}

}  // namespace

// cols (N, Z, J) float32; w, aff the flat weight and affine buffers (see
// above); out (N, Z) float32. Z % 4 == 0.
FVP_API int fvp_c2cnet(const float* cols, const void* w, const float* aff,
                       float* out, int N, int Z, int J, void* stream) {
  if (N <= 0 || Z <= 0 || Z % 4 || J <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Z, J);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        c2cnet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  c2cnet_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      cols, static_cast<const bf16*>(w), aff, out, Z, J);
  return (int)cudaGetLastError();
}

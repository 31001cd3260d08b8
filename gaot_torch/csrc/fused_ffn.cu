// Fused SwiGLU forward for Hopper (sm_90a), bf16:
//   out = (silu(x W1^T) * (x W3^T)) W2^T,
// x [R, M], W1 and W3 [F, M], W2 [M, F] (torch Linear layouts), out [R, M].
// One block per 64-row tile of x, four warps of 16 rows. The x tile stays in
// shared memory while the block walks F in chunks of 32: h1 and h3 come from
// the tensor cores (mma.sync m16n8k16, fp32 accumulation), z = silu(h1) * h3
// is rounded to bf16 in registers (the accumulator layout of one product is
// the operand layout of the next) and out += z W2^T accumulates in fp32
// registers. h1, h3 and z never reach device memory. Rows past R are masked.
// Plain C interface; returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows per block
constexpr int FC = 32;   // F chunk per step
constexpr int PAD = 8;   // bf16 row padding: conflict-free fragment loads

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <int M>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)BM * (M + PAD) + 2 * (size_t)FC * (M + PAD) +
                         (size_t)M * (FC + PAD));
}

template <int M>
__global__ void __launch_bounds__(128)
ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ w3, const bf16* __restrict__ w2,
               bf16* __restrict__ out, int R, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = M + PAD;    // row stride of the x and W1/W3 tiles
  constexpr int WS = FC + PAD;   // row stride of the W2 tile
  bf16* Xs = reinterpret_cast<bf16*>(smem);           // [BM][XS]
  bf16* W1s = Xs + BM * XS;                           // [FC][XS]
  bf16* W3s = W1s + FC * XS;                          // [FC][XS]
  bf16* W2s = W3s + FC * XS;                          // [M][WS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int wr = warp * 16;       // warp's first row within the tile

  for (int i = threadIdx.x; i < BM * (M / 8); i += blockDim.x) {
    const int r = i / (M / 8), ch = (i % (M / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < R)
      val = *reinterpret_cast<const uint4*>(x + (long long)(row0 + r) * M + ch);
    *reinterpret_cast<uint4*>(Xs + r * XS + ch) = val;
  }

  float acc[M / 8][4];
#pragma unroll
  for (int n = 0; n < M / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();
    for (int i = threadIdx.x; i < FC * (M / 8); i += blockDim.x) {
      const int r = i / (M / 8), ch = (i % (M / 8)) * 8;
      const long long src = (long long)(f0 + r) * M + ch;
      *reinterpret_cast<uint4*>(W1s + r * XS + ch) =
          *reinterpret_cast<const uint4*>(w1 + src);
      *reinterpret_cast<uint4*>(W3s + r * XS + ch) =
          *reinterpret_cast<const uint4*>(w3 + src);
    }
    for (int i = threadIdx.x; i < M * (FC / 8); i += blockDim.x) {
      const int r = i / (FC / 8), ch = (i % (FC / 8)) * 8;
      *reinterpret_cast<uint4*>(W2s + r * WS + ch) =
          *reinterpret_cast<const uint4*>(w2 + (long long)r * F + f0 + ch);
    }
    __syncthreads();

    float h1[FC / 8][4], h3[FC / 8][4];
#pragma unroll
    for (int j = 0; j < FC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h1[j][e] = h3[j][e] = 0.f;
#pragma unroll 4
    for (int st = 0; st < M / 16; ++st) {
      const bf16* xa = Xs + (wr + g) * XS + st * 16 + 2 * t;
      const uint32_t a[4] = {ld32(xa), ld32(xa + 8 * XS), ld32(xa + 8),
                             ld32(xa + 8 * XS + 8)};
#pragma unroll
      for (int j = 0; j < FC / 8; ++j) {
        const bf16* b1p = W1s + (8 * j + g) * XS + st * 16 + 2 * t;
        const bf16* b3p = W3s + (8 * j + g) * XS + st * 16 + 2 * t;
        mma_bf16_16816(h1[j], a, ld32(b1p), ld32(b1p + 8));
        mma_bf16_16816(h3[j], a, ld32(b3p), ld32(b3p + 8));
      }
    }
    // z = silu(h1) * h3 in bf16: n-tiles 2st, 2st+1 form k-step st of z.
    uint32_t za[FC / 16][4];
#pragma unroll
    for (int st = 0; st < FC / 16; ++st) {
      const int j0 = 2 * st, j1 = 2 * st + 1;
      za[st][0] = pack_bf16(silu(h1[j0][0]) * h3[j0][0], silu(h1[j0][1]) * h3[j0][1]);
      za[st][1] = pack_bf16(silu(h1[j0][2]) * h3[j0][2], silu(h1[j0][3]) * h3[j0][3]);
      za[st][2] = pack_bf16(silu(h1[j1][0]) * h3[j1][0], silu(h1[j1][1]) * h3[j1][1]);
      za[st][3] = pack_bf16(silu(h1[j1][2]) * h3[j1][2], silu(h1[j1][3]) * h3[j1][3]);
    }
#pragma unroll
    for (int n = 0; n < M / 8; ++n) {
#pragma unroll
      for (int st = 0; st < FC / 16; ++st) {
        const bf16* bp = W2s + (8 * n + g) * WS + st * 16 + 2 * t;
        mma_bf16_16816(acc[n], za[st], ld32(bp), ld32(bp + 8));
      }
    }
  }

  const int r0 = row0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < M / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < R)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r0 * M + c) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r1 < R)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r1 * M + c) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int M>
cudaError_t launch(const void* x, const void* w1, const void* w3,
                   const void* w2, void* out, int R, int F,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<M>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ffn_fwd_kernel<M><<<(R + BM - 1) / BM, 128, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), R, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gaot_fused_ffn_fwd(const void* x, const void* w1, const void* w3,
                                  const void* w2, void* out, int R, int M,
                                  int F, void* stream) {
  if (R <= 0 || F <= 0 || F % FC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Built for the UViT hidden size of the configurations the port runs.
  if (M == 256) return (int)launch<256>(x, w1, w3, w2, out, R, F, s);
  return (int)cudaErrorInvalidValue;
}

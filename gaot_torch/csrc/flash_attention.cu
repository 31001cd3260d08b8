// Grouped-query attention forward for Hopper (sm_90a), head dim 32.
//   out = softmax(Q K^T / sqrt(D)) V,  kv-head = head / (H / Hkv).
// One block per (batch * q-head, 64-query tile). K/V stream through shared
// memory in tiles of 64 keys with an online softmax (fp32 running max and
// denominator, exp2 with the scale folded with log2 e). P is cast to V's
// dtype before the P.V product and the output is normalised once at the end.
// bf16: four warps of 16 query rows on the tensor cores (mma.sync m16n8k16,
// fp32 accumulation). fp32: one thread per query row on the CUDA cores.
// Plain C interface; returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 32;        // head dim the kernels are built for
constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int KPAD = D + 8;  // K tile row stride (bf16): conflict-free fragments
constexpr int VPAD = BK + 8; // transposed V tile row stride (bf16)

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;
};

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

__global__ void __launch_bounds__(128)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, int S,
               int H, int Hkv, Strides qs, Strides ks, Strides vs,
               float scale_log2) {
  __shared__ __align__(16) bf16 Ks[BK][KPAD];
  __shared__ __align__(16) bf16 Vt[D][VPAD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BQ + warp * 16 + g;
  const int r1 = r0 + 8;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // Q fragments of this warp's 16 rows: two k-steps of 16 over D = 32.
  uint32_t qa[2][4];
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int c = st * 16 + 2 * t;
    qa[st][0] = r0 < S ? ld32(qb + r0 * qs.s + c) : 0u;
    qa[st][1] = r1 < S ? ld32(qb + r1 * qs.s + c) : 0u;
    qa[st][2] = r0 < S ? ld32(qb + r0 * qs.s + c + 8) : 0u;
    qa[st][3] = r1 < S ? ld32(qb + r1 * qs.s + c + 8) : 0u;
  }

  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < S; kt += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (D / 8); i += blockDim.x) {
      const int key = i / (D / 8), ch = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kt + key < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (kt + key) * ks.s + ch);
        vv = *reinterpret_cast<const uint4*>(vb + (kt + key) * vs.s + ch);
      }
      *reinterpret_cast<uint4*>(&Ks[key][ch]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[ch + j][key] = ve[j];
    }
    __syncthreads();

    // Scores for 16 rows x 64 keys: eight n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const bf16* kr = &Ks[8 * j + g][st * 16 + 2 * t];
        mma_bf16_16816(s[j], qa[st], ld32(kr), ld32(kr + 8));
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + 2 * t + (e & 1);
        s[j][e] = key < S ? s[j][e] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // P (bf16) . V: the score accumulators of n-tiles 2st, 2st+1 are the
    // A fragment of k-step st.
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * st][0], s[2 * st][1]);
      pa[1] = pack_bf16(s[2 * st][2], s[2 * st][3]);
      pa[2] = pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]);
      pa[3] = pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* vr = &Vt[8 * n + g][st * 16 + 2 * t];
        mma_bf16_16816(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * S + r0) * H + h) * D + c) =
          __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * S + r1) * H + h) * D + c) =
          __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
}

__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
              int H, int Hkv, Strides qs, Strides ks, Strides vs,
              float scale_log2) {
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int row = blockIdx.y * BQ + threadIdx.x;
  const bool valid = row < S;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float qr[D], o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? q[b * qs.b + row * qs.s + h * qs.h + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  for (int kt = 0; kt < S; kt += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (D / 4); i += blockDim.x) {
      const int key = i / (D / 4), ch = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kt + key < S) {
        kv = *reinterpret_cast<const float4*>(kb + (kt + key) * ks.s + ch);
        vv = *reinterpret_cast<const float4*>(vb + (kt + key) * vs.s + ch);
      }
      *reinterpret_cast<float4*>(&Ks[key][ch]) = kv;
      *reinterpret_cast<float4*>(&Vs[key][ch]) = vv;
    }
    __syncthreads();

    float s[BK];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      s[j] = kt + j < S ? dot * scale_log2 : -CUDART_INF_F;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = exp2f(s[j] - mn);
      sum += s[j];
    }
    l = l * alpha + sum;
    m = mn;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j)
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(s[j], Vs[j][d], o[d]);
  }
  if (valid) {
    float* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = o[d] / l;
  }
}

}  // namespace

extern "C" int gaot_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, int B, int S, int H, int Hkv,
                              long long qsb, long long qss, long long qsh,
                              long long ksb, long long kss, long long ksh,
                              long long vsb, long long vss, long long vsh,
                              float scale_log2, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  if (dtype == 1) {
    flash_fwd_bf16<<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, Hkv, qs,
        ks, vs, scale_log2);
  } else if (dtype == 0) {
    flash_fwd_f32<<<grid, BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, H, Hkv,
        qs, ks, vs, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

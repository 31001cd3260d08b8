// Grouped-query attention for Hopper (sm_90a), forward and backward:
//   out = softmax(Q K^T / sqrt(D)) V,  kv-head = head / (H / Hkv).
// Every kernel is a template on the head dim D, instantiated for D = 24 and
// D = 32 (the 3D and 2D UViT configurations); the entry points dispatch on D
// and refuse any other.
// Forward:
// One block per (batch * q-head, 64-query tile). K/V stream through shared
// memory in tiles of 64 keys with an online softmax (fp32 running max and
// denominator, exp2 with the scale folded with log2 e). P is cast to V's
// dtype before the P.V product and the output is normalised once at the end.
// With an LSE pointer it also writes the base-2 log-sum-exp m + log2(l) of
// every row, which training keeps for the backward (further below).
// bf16: four warps of 16 query rows on the tensor cores (mma.sync m16n8k16,
// fp32 accumulation). Products that contract over D take ceil(D / 16)
// k-steps; the fragment columns at or past D are zero registers (at D = 24
// the second k-step's upper half), and zero columns change neither QK^T nor
// dO V^T. Products whose N dimension is D take D / 8 n-tiles. fp32: one
// thread per query row on the CUDA cores, looping over D.
// Plain C interface; each entry returns cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int VPAD = BK + 8; // transposed tile row stride (bf16)

template <int D>
struct Dims {
  static constexpr int KSTEPS = (D + 15) / 16;  // k-steps of 16 over D
  static constexpr int NT = D / 8;              // n-tiles of 8 over D
  // Row stride (bf16) of a tile whose fragments are read along D: an odd
  // number of 16-byte chunks puts the 8 rows of a fragment load on distinct
  // banks (D = 24: 24, D = 32: 40).
  static constexpr int KPAD = (D / 8) % 2 ? D : D + 8;
  static_assert(D % 8 == 0 && D <= 64, "head dim must be a multiple of 8, at most 64");
};

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

// A fragment (16 rows x 16 of D) of k-step st, rows r0 and r0 + 8 at p0 and
// p1 (read only where ok0 / ok1); columns at or past D are zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* p0,
                                       const bf16* p1, bool ok0, bool ok1,
                                       int st, int t) {
  const int c = st * 16 + 2 * t;
  const bool lo = st * 16 < D, hi = st * 16 + 8 < D;
  a[0] = ok0 && lo ? ld32(p0 + c) : 0u;
  a[1] = ok1 && lo ? ld32(p1 + c) : 0u;
  a[2] = ok0 && hi ? ld32(p0 + c + 8) : 0u;
  a[3] = ok1 && hi ? ld32(p1 + c + 8) : 0u;
}

// c += A . B for k-step st of a product contracting over D; kr points at
// column st * 16 + 2t of the B row in shared memory.
template <int D>
__device__ __forceinline__ void mma_over_d(float c[4], const uint32_t a[4],
                                           const bf16* kr, int st) {
  const uint32_t b1 = st * 16 + 8 < D ? ld32(kr + 8) : 0u;
  mma_bf16_16816(c, a, ld32(kr), b1);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int S, int H, int Hkv, Strides qs,
               Strides ks, Strides vs, float scale_log2) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 Ks[BK][Dm::KPAD];
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

  // Q fragments of this warp's 16 rows.
  uint32_t qa[Dm::KSTEPS][4];
#pragma unroll
  for (int st = 0; st < Dm::KSTEPS; ++st)
    load_a<D>(qa[st], qb + (long long)r0 * qs.s, qb + (long long)r1 * qs.s,
              r0 < S, r1 < S, st, t);

  float o[Dm::NT][4];
#pragma unroll
  for (int n = 0; n < Dm::NT; ++n)
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
      for (int st = 0; st < Dm::KSTEPS; ++st)
        mma_over_d<D>(s[j], qa[st], &Ks[8 * j + g][st * 16 + 2 * t], st);
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
    for (int n = 0; n < Dm::NT; ++n) {
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
      for (int n = 0; n < Dm::NT; ++n) {
        const bf16* vr = &Vt[8 * n + g][st * 16 + 2 * t];
        mma_bf16_16816(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < Dm::NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * S + r0) * H + h) * D + c) =
          __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * S + r1) * H + h) * D + c) =
          __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[(long long)bh * S + r0] = m0 + log2f(l0);
    if (r1 < S) lse[(long long)bh * S + r1] = m1 + log2f(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int S, int H, int Hkv, Strides qs,
              Strides ks, Strides vs, float scale_log2) {
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
    if (lse != nullptr) lse[(long long)bh * S + row] = m + log2f(l);
  }
}


// ---------------------------------------------------------------------------
// Backward from the forward's base-2 row LSE (the kv-tiled flash backward):
//   p = exp2(s * scale_log2 - lse)     normalised probabilities
//   delta = rowsum(dO * O)             flash_bwd_delta, fp32, once
//   dS = p * (dO V^T - delta)
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = p^T dO
// Two deterministic kernels, no atomics: dQ with one block per
// (batch * q-head, 64-query tile) looping over the key tiles; dK/dV with one
// block per (batch * kv-head, 64-key tile) looping over the group's q-heads
// and every query tile, so the GQA group sum stays in fp32 registers. In bf16
// p and dS are rounded to bf16 before their products, as the TPU kernels do.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// delta[b, h, s] = sum_d dout[b, s, h, d] * o[b, s, h, d]; rows in [B, S, H]
// order, dout and o contiguous.
template <typename T, int D>
__global__ void flash_bwd_delta(const T* __restrict__ dout,
                                const T* __restrict__ o,
                                float* __restrict__ delta, int S, int H,
                                long long rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const T* a = dout + i * D;
  const T* c = o + i * D;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc += to_f(a[d]) * to_f(c[d]);
  const long long bs = i / H;
  const int h = (int)(i % H);
  const long long b = bs / S;
  const int s = (int)(bs % S);
  delta[(b * H + h) * S + s] = acc;
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int H, int Hkv, Strides qs,
                  Strides ks, Strides vs, float scale_log2, float scale) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 Ks[BK][Dm::KPAD];
  __shared__ __align__(16) bf16 Vs[BK][Dm::KPAD];
  __shared__ __align__(16) bf16 Kt[D][VPAD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const long long drs = (long long)H * D;     // row stride of dout

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const bf16* db = dout + ((long long)b * S * H + h) * D;

  // Q and dO fragments of this warp's 16 rows (A operands of S and dP).
  uint32_t qa[Dm::KSTEPS][4], da[Dm::KSTEPS][4];
#pragma unroll
  for (int st = 0; st < Dm::KSTEPS; ++st) {
    load_a<D>(qa[st], qb + (long long)r0 * qs.s, qb + (long long)r1 * qs.s,
              r0 < S, r1 < S, st, t);
    load_a<D>(da[st], db + r0 * drs, db + r1 * drs, r0 < S, r1 < S, st, t);
  }
  const float* lrow = lse + (long long)bh * S;
  const float* drow = delta + (long long)bh * S;
  const float lse0 = r0 < S ? lrow[r0] : 0.f, lse1 = r1 < S ? lrow[r1] : 0.f;
  const float dl0 = r0 < S ? drow[r0] : 0.f, dl1 = r1 < S ? drow[r1] : 0.f;

  float acc[Dm::NT][4];
#pragma unroll
  for (int n = 0; n < Dm::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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
      *reinterpret_cast<uint4*>(&Vs[key][ch]) = vv;
      const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Kt[ch + j][key] = ke[j];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int st = 0; st < Dm::KSTEPS; ++st) {
        mma_over_d<D>(s[j], qa[st], &Ks[8 * j + g][st * 16 + 2 * t], st);
        mma_over_d<D>(dp[j], da[st], &Vs[8 * j + g][st * 16 + 2 * t], st);
      }
    }
    // dS = p (dP - delta), in place of S.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + 2 * t + (e & 1);
        const bool lo = e < 2;
        const float p = key < S ? exp2f(s[j][e] * scale_log2 - (lo ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (lo ? dl0 : dl1));
      }
    }
    // dQ += dS (bf16) K: n-tiles 2st, 2st+1 of dS are the A fragment of k-step st.
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * st][0], s[2 * st][1]);
      pa[1] = pack_bf16(s[2 * st][2], s[2 * st][3]);
      pa[2] = pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]);
      pa[3] = pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3]);
#pragma unroll
      for (int n = 0; n < Dm::NT; ++n) {
        const bf16* kr = &Kt[8 * n + g][st * 16 + 2 * t];
        mma_bf16_16816(acc[n], pa, ld32(kr), ld32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < Dm::NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + (((long long)b * S + r0) * H + h) * D + c) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + (((long long)b * S + r1) * H + h) * D + c) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                   int Hkv, Strides qs, Strides ks, Strides vs,
                   float scale_log2, float scale) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 Qs[BQ][Dm::KPAD];   // [query][d]
  __shared__ __align__(16) bf16 Ds[BQ][Dm::KPAD];   // dO [query][d]
  __shared__ __align__(16) bf16 Qt[D][VPAD];        // [d][query]
  __shared__ __align__(16) bf16 Dt[D][VPAD];        // dO [d][query]
  __shared__ float Ls[BQ], Dl[BQ];

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BK + warp * 16 + g;  // key rows
  const int r1 = r0 + 8;
  const long long drs = (long long)H * D;

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  // K and V fragments of this warp's 16 keys (A operands of S^T and dP^T).
  uint32_t ka[Dm::KSTEPS][4], va[Dm::KSTEPS][4];
#pragma unroll
  for (int st = 0; st < Dm::KSTEPS; ++st) {
    load_a<D>(ka[st], kb + (long long)r0 * ks.s, kb + (long long)r1 * ks.s,
              r0 < S, r1 < S, st, t);
    load_a<D>(va[st], vb + (long long)r0 * vs.s, vb + (long long)r1 * vs.s,
              r0 < S, r1 < S, st, t);
  }
  float dka[Dm::NT][4], dva[Dm::NT][4];
#pragma unroll
  for (int n = 0; n < Dm::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* db = dout + ((long long)b * S * H + h) * D;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = 0; qt < S; qt += BQ) {
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * (D / 8); i += blockDim.x) {
        const int row = i / (D / 8), ch = (i % (D / 8)) * 8;
        uint4 qv = make_uint4(0, 0, 0, 0), dv8 = make_uint4(0, 0, 0, 0);
        if (qt + row < S) {
          qv = *reinterpret_cast<const uint4*>(qb + (qt + row) * qs.s + ch);
          dv8 = *reinterpret_cast<const uint4*>(db + (qt + row) * drs + ch);
        }
        *reinterpret_cast<uint4*>(&Qs[row][ch]) = qv;
        *reinterpret_cast<uint4*>(&Ds[row][ch]) = dv8;
        const bf16* qe = reinterpret_cast<const bf16*>(&qv);
        const bf16* de = reinterpret_cast<const bf16*>(&dv8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          Qt[ch + j][row] = qe[j];
          Dt[ch + j][row] = de[j];
        }
      }
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        const bool ok = qt + i < S;
        Ls[i] = ok ? lrow[qt + i] : CUDART_INF_F;   // exp2(-inf) = 0
        Dl[i] = ok ? drow[qt + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 64 queries.
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int st = 0; st < Dm::KSTEPS; ++st) {
          mma_over_d<D>(s[j], ka[st], &Qs[8 * j + g][st * 16 + 2 * t], st);
          mma_over_d<D>(dp[j], va[st], &Ds[8 * j + g][st * 16 + 2 * t], st);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float p = exp2f(s[j][e] * scale_log2 - Ls[col]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dl[col]);
        }
      }
      // dV += P^T (bf16) dO and dK += dS^T (bf16) Q over this query tile.
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(s[2 * st][0], s[2 * st][1]);
        pa[1] = pack_bf16(s[2 * st][2], s[2 * st][3]);
        pa[2] = pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]);
        pa[3] = pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3]);
        sa[0] = pack_bf16(dp[2 * st][0], dp[2 * st][1]);
        sa[1] = pack_bf16(dp[2 * st][2], dp[2 * st][3]);
        sa[2] = pack_bf16(dp[2 * st + 1][0], dp[2 * st + 1][1]);
        sa[3] = pack_bf16(dp[2 * st + 1][2], dp[2 * st + 1][3]);
#pragma unroll
        for (int n = 0; n < Dm::NT; ++n) {
          const bf16* dr = &Dt[8 * n + g][st * 16 + 2 * t];
          mma_bf16_16816(dva[n], pa, ld32(dr), ld32(dr + 8));
          const bf16* qr = &Qt[8 * n + g][st * 16 + 2 * t];
          mma_bf16_16816(dka[n], sa, ld32(qr), ld32(qr + 8));
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < Dm::NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S) {
      const long long o = (((long long)b * S + r0) * Hkv + hk) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (r1 < S) {
      const long long o = (((long long)b * S + r1) * Hkv + hk) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// fp32 backward on the CUDA cores: one thread per query row (dQ) or per key
// row (dK/dV), the other side streamed through shared memory in 64-row tiles.
template <int D>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int H, int Hkv, Strides qs,
                 Strides ks, Strides vs, float scale_log2, float scale) {
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int row = blockIdx.y * BQ + threadIdx.x;
  const bool valid = row < S;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const float* drow = dout + (((long long)b * S + row) * H + h) * D;

  float qr[D], dr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? q[b * qs.b + row * qs.s + h * qs.h + d] : 0.f;
    dr[d] = valid ? drow[d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse_r = valid ? lse[(long long)bh * S + row] : 0.f;
  const float dl = valid ? delta[(long long)bh * S + row] : 0.f;

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
    const int kn = min(BK, S - kt);
    for (int j = 0; j < kn; ++j) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sd = fmaf(qr[d], Ks[j][d], sd);
        pd = fmaf(dr[d], Vs[j][d], pd);
      }
      const float p = exp2f(sd * scale_log2 - lse_r);
      const float ds = p * (pd - dl);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
    }
  }
  if (valid) {
    float* o = dq + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(BK)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                  int Hkv, Strides qs, Strides ks, Strides vs,
                  float scale_log2, float scale) {
  __shared__ __align__(16) float Qs[BQ][D];
  __shared__ __align__(16) float Ds[BQ][D];
  __shared__ float Ls[BQ], Dl[BQ];

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int row = blockIdx.y * BK + threadIdx.x;   // key row
  const bool valid = row < S;
  const long long drs = (long long)H * D;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = valid ? k[b * ks.b + row * ks.s + hk * ks.h + d] : 0.f;
    vr[d] = valid ? v[b * vs.b + row * vs.s + hk * vs.h + d] : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* db = dout + ((long long)b * S * H + h) * D;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = 0; qt < S; qt += BQ) {
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * (D / 4); i += blockDim.x) {
        const int r = i / (D / 4), ch = (i % (D / 4)) * 4;
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), dv4 = qv;
        if (qt + r < S) {
          qv = *reinterpret_cast<const float4*>(qb + (qt + r) * qs.s + ch);
          dv4 = *reinterpret_cast<const float4*>(db + (qt + r) * drs + ch);
        }
        *reinterpret_cast<float4*>(&Qs[r][ch]) = qv;
        *reinterpret_cast<float4*>(&Ds[r][ch]) = dv4;
      }
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        Ls[i] = qt + i < S ? lrow[qt + i] : 0.f;
        Dl[i] = qt + i < S ? drow[qt + i] : 0.f;
      }
      __syncthreads();
      const int qn = min(BQ, S - qt);
      for (int j = 0; j < qn; ++j) {
        float sd = 0.f, pd = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          sd = fmaf(Qs[j][d], kr[d], sd);
          pd = fmaf(Ds[j][d], vr[d], pd);
        }
        const float p = exp2f(sd * scale_log2 - Ls[j]);
        const float ds = p * (pd - Dl[j]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, Ds[j][d], dva[d]);
          dka[d] = fmaf(ds, Qs[j][d], dka[d]);
        }
      }
    }
  }
  if (valid) {
    const long long o = (((long long)b * S + row) * Hkv + hk) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[o + d] = dka[d] * scale;
      dv[o + d] = dva[d];
    }
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, int Hkv, Strides qs,
               Strides ks, Strides vs, float scale_log2, int dtype,
               cudaStream_t st) {
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  if (dtype == 1) {
    flash_fwd_bf16<D><<<grid, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, Hkv,
        qs, ks, vs, scale_log2);
  } else {
    flash_fwd_f32<D><<<grid, BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, Hkv,
        qs, ks, vs, scale_log2);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* l, float* dl, void* dq, void* dk,
               void* dv, int B, int S, int H, int Hkv, Strides qs, Strides ks,
               Strides vs, float scale_log2, float scale, int dtype,
               cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  const int dblocks = (int)((rows + 255) / 256);
  const dim3 gq(B * H, (S + BQ - 1) / BQ), gk(B * Hkv, (S + BK - 1) / BK);
  if (dtype == 1) {
    flash_bwd_delta<bf16, D><<<dblocks, 256, 0, st>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(o), dl, S, H, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_bf16<D><<<gq, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
        static_cast<bf16*>(dq), S, H, Hkv, qs, ks, vs, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_bf16<D><<<gk, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, Hkv, qs, ks, vs,
        scale_log2, scale);
  } else {
    flash_bwd_delta<float, D><<<dblocks, 256, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(o), dl, S, H, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32<D><<<gq, BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), S, H, Hkv, qs, ks, vs, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32<D><<<gk, BK, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), S, H, Hkv, qs, ks, vs,
        scale_log2, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H or Hkv, D] with the given element strides (D
// contiguous); out contiguous [B, S, H, D]; lse (optional) fp32 [B, H, S].
extern "C" int gaot_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int S, int H,
                              int Hkv, int D, long long qsb, long long qss,
                              long long qsh, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss,
                              long long vsh, float scale_log2, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 24:
      return launch_fwd<24>(q, k, v, out, l, B, S, H, Hkv, qs, ks, vs, scale_log2, dtype, st);
    case 32:
      return launch_fwd<32>(q, k, v, out, l, B, S, H, Hkv, qs, ks, vs, scale_log2, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dq, dk, dv contiguous ([B, S, H, D], [B, S, Hkv, D]); o and dout contiguous
// [B, S, H, D]; lse and the delta scratch fp32 [B, H, S].
extern "C" int gaot_flash_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse,
                              void* delta, void* dq, void* dk, void* dv, int B,
                              int S, int H, int Hkv, int D, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, float scale_log2,
                              float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 24:
      return launch_bwd<24>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, Hkv,
                            qs, ks, vs, scale_log2, scale, dtype, st);
    case 32:
      return launch_bwd<32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, Hkv,
                            qs, ks, vs, scale_log2, scale, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

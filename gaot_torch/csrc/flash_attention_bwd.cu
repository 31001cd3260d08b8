// Grouped-query attention backward for Hopper (sm_90a), bf16 and fp32, from
// the forward's base-2 row LSE; replaces the three regimes of the TPU
// backward in gaot_tpu/ops/pallas/flash_attention.py (_flash_backward at
// S <= 1024 and at S <= 4096, _flash_backward_long beyond). Every kernel
// but the *_wide ones is a template on the head dim D, instantiated for
// every multiple of 8 from 8 to 128 (flash_common.cuh); head dims above 128
// take the *_wide kernels, with D at run time. The products that contract
// over D take ceil(D / 16) k-steps of mma.sync m16n8k16 whose fragment
// columns at or past D are zero registers; the products whose N dimension is
// D take D / 8 n-tiles. Above D = 64 the fp32 kernels stream tiles of 32 rows, so that
// their shared memory stays static, and the bf16 kernels take theirs
// dynamically. Plain C interface; the entry returns cudaGetLastError() after
// its launches.
#include "flash_common.cuh"

namespace {

using namespace flash;

// Rows of the streamed tiles of the fp32 kernels.
template <int D>
struct F32Tile {
  static constexpr int ROWS = D > 64 ? 32 : 64;
};

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

// Dynamic shared memory of the bf16 backward kernels, in bytes (above the
// 48 KB of static shared memory from D = 104 on).
template <int D>
struct DqSmem {
  static constexpr int KV = BK * Dims<D>::KPAD * 2;
  static constexpr int V = KV, KT = 2 * KV, BYTES = KT + D * VPAD * 2;
};
template <int D>
struct DkvSmem {
  static constexpr int QD = BQ * Dims<D>::KPAD * 2, T = D * VPAD * 2;
  static constexpr int DS = QD, QT = 2 * QD, DT = QT + T, LS = DT + T,
                       BYTES = LS + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int H, int Hkv, Strides qs,
                  Strides ks, Strides vs, float scale_log2, float scale) {
  using Dm = Dims<D>;
  using Sm = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<bf16 (*)[Dm::KPAD]>(smem);                  // [BK][KPAD]
  auto Vs = reinterpret_cast<bf16 (*)[Dm::KPAD]>(smem + Sm::V);          // [BK][KPAD]
  auto Kt = reinterpret_cast<bf16 (*)[VPAD]>(smem + Sm::KT);             // [D][VPAD]

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
  using Sm = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Qs = reinterpret_cast<bf16 (*)[Dm::KPAD]>(smem);                  // [query][d]
  auto Ds = reinterpret_cast<bf16 (*)[Dm::KPAD]>(smem + Sm::DS);         // dO [query][d]
  auto Qt = reinterpret_cast<bf16 (*)[VPAD]>(smem + Sm::QT);             // [d][query]
  auto Dt = reinterpret_cast<bf16 (*)[VPAD]>(smem + Sm::DT);             // dO [d][query]
  float* Ls = reinterpret_cast<float*>(smem + Sm::LS);
  float* Dl = Ls + BQ;

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
// row (dK/dV), the other side streamed through shared memory in tiles of
// F32Tile<D>::ROWS rows.
template <int D>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int H, int Hkv, Strides qs,
                 Strides ks, Strides vs, float scale_log2, float scale) {
  constexpr int KT = F32Tile<D>::ROWS;
  __shared__ __align__(16) float Ks[KT][D];
  __shared__ __align__(16) float Vs[KT][D];

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

  for (int kt = 0; kt < S; kt += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < KT * (D / 4); i += blockDim.x) {
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
    const int kn = min(KT, S - kt);
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
  constexpr int QT = F32Tile<D>::ROWS;
  __shared__ __align__(16) float Qs[QT][D];
  __shared__ __align__(16) float Ds[QT][D];
  __shared__ float Ls[QT], Dl[QT];

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
    for (int qt = 0; qt < S; qt += QT) {
      __syncthreads();
      for (int i = threadIdx.x; i < QT * (D / 4); i += blockDim.x) {
        const int r = i / (D / 4), ch = (i % (D / 4)) * 4;
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), dv4 = qv;
        if (qt + r < S) {
          qv = *reinterpret_cast<const float4*>(qb + (qt + r) * qs.s + ch);
          dv4 = *reinterpret_cast<const float4*>(db + (qt + r) * drs + ch);
        }
        *reinterpret_cast<float4*>(&Qs[r][ch]) = qv;
        *reinterpret_cast<float4*>(&Ds[r][ch]) = dv4;
      }
      for (int i = threadIdx.x; i < QT; i += blockDim.x) {
        Ls[i] = qt + i < S ? lrow[qt + i] : 0.f;
        Dl[i] = qt + i < S ? drow[qt + i] : 0.f;
      }
      __syncthreads();
      const int qn = min(QT, S - qt);
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
int launch_bwd_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* l, float* dl, void* dq, void* dk,
               void* dv, int B, int S, int H, int Hkv, Strides qs, Strides ks,
               Strides vs, float scale_log2, float scale, int dtype,
               cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  const int dblocks = (int)((rows + 255) / 256);
  const dim3 gq(B * H, (S + BQ - 1) / BQ), gk(B * Hkv, (S + BK - 1) / BK);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkvSmem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_delta<bf16, D><<<dblocks, 256, 0, st>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(o), dl, S, H, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_bf16<D><<<gq, 128, DqSmem<D>::BYTES, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
        static_cast<bf16*>(dq), S, H, Hkv, qs, ks, vs, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_bf16<D><<<gk, 128, DkvSmem<D>::BYTES, st>>>(
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

// ---- Head dims above 128 (flash_common.cuh), D at run time.
// delta[b, h, s] = sum_d dout * o: one warp per row.
template <typename T>
__global__ void flash_bwd_delta_wide(const T* __restrict__ dout, const T* __restrict__ o,
                                     float* __restrict__ delta, int S, int H, int D,
                                     long long rows) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= rows) return;
  const T* a = dout + i * D;
  const T* c = o + i * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(a[d]) * to_f(c[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bs = i / H;
    delta[(bs / S * H + i % H) * S + bs % S] = acc;
  }
}

// s[u][w] += sum over one head-dim slice of A[4 ty + u] . B[4 tx + w].
__device__ __forceinline__ void wide_dots(float s[4][4], const float* A, const float* B,
                                          int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < WS; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = A[(4 * ty + u) * WSP + d];
      c[u] = B[(4 * tx + u) * WSP + d];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = fmaf(a[u], c[w], s[u][w]);
  }
}

// acc[u][w] += sum_j L[4 ty + u][j] R[j][tx + 16 w] over the WR rows j.
__device__ __forceinline__ void wide_accumulate(float acc[4][8], const float* L,
                                                const float* R, int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < WR; ++j) {
    float rv[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) rv[w] = R[j * WOP + tx + 16 * w];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float l = L[(4 * ty + u) * WSP + j];
#pragma unroll
      for (int w = 0; w < 8; ++w) acc[u][w] = fmaf(l, rv[w], acc[u][w]);
    }
  }
}

// dQ: one block per (batch * q-head, 64 queries, 128 columns of dQ). Per
// tile of 64 keys: S = Q K^T and dP = dO V^T over the full D in slices,
// dS = p (dP - delta) with p from the LSE, rounded to T; dQ += dS K.
constexpr int WIDE_DQ_SMEM = (4 * WR * WSP + WR * WSP + 2 * WR) * 4;

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dq, int S, int H, int Hkv, int D, Strides qs,
                  Strides ks, Strides vs, float scale_log2, float scale) {
  extern __shared__ float wsm[];
  float *Qs = wsm, *Ks = Qs + WR * WSP, *Ds = Ks + WR * WSP, *Vs = Ds + WR * WSP;
  float* Kv = wsm;                        // [WR][WOP], over the slices
  float* Ss = wsm + 4 * WR * WSP;         // dS [query][key]
  float *Ls = Ss + WR * WSP, *Dl = Ls + WR;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.y * WR, c0 = blockIdx.z * WO;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const T* db = dout + ((long long)b * S * H + h) * D;
  if (threadIdx.x < WR) {
    const bool ok = q0 + threadIdx.x < S;
    Ls[threadIdx.x] = ok ? lse[(long long)bh * S + q0 + threadIdx.x] : 0.f;
    Dl[threadIdx.x] = ok ? delta[(long long)bh * S + q0 + threadIdx.x] : 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 8; ++w) acc[u][w] = 0.f;

  for (int kt = 0; kt < S; kt += WR) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = dp[u][w] = 0.f;
    for (int d0 = 0; d0 < D; d0 += WS) {
      __syncthreads();
      load_rows_f32(Qs, WSP, qb, qs.s, q0, S, d0, D, WS);
      load_rows_f32(Ks, WSP, kb, ks.s, kt, S, d0, D, WS);
      load_rows_f32(Ds, WSP, db, (long long)H * D, q0, S, d0, D, WS);
      load_rows_f32(Vs, WSP, vb, vs.s, kt, S, d0, D, WS);
      __syncthreads();
      wide_dots(s, Qs, Ks, ty, tx);
      wide_dots(dp, Ds, Vs, ty, tx);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * ty + u;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int key = kt + 4 * tx + w;
        const float p = key < S ? exp2f(s[u][w] * scale_log2 - Ls[r]) : 0.f;
        Ss[r * WSP + 4 * tx + w] = round_to(p * (dp[u][w] - Dl[r]), T());
      }
    }
    __syncthreads();
    load_rows_f32(Kv, WOP, kb, ks.s, kt, S, c0, D, WO);
    __syncthreads();
    wide_accumulate(acc, Ss, Kv, ty, tx);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = q0 + 4 * ty + u;
    if (row >= S) continue;
    T* o = dq + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int c = c0 + tx + 16 * w;
      if (c < D) o[c] = T(acc[u][w] * scale);
    }
  }
}

// dK, dV: one block per (batch * kv-head, 64 keys, 128 columns of dK and
// dV), looping over the group's q-heads and every tile of 64 queries:
// S^T = K Q^T and dP^T = V dO^T over the full D in slices, p from the LSE
// and dS = p (dP - delta), both rounded to T; dV += P^T dO, dK += dS^T Q.
constexpr int WIDE_DKV_SMEM = (4 * WR * WSP + 2 * WR * WSP + 2 * WR) * 4;

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv,
                   int D, Strides qs, Strides ks, Strides vs, float scale_log2,
                   float scale) {
  extern __shared__ float wsm[];
  float *Ks = wsm, *Vs = Ks + WR * WSP, *Qs = Vs + WR * WSP, *Ds = Qs + WR * WSP;
  float *Qv = wsm, *Dv = wsm + WR * WOP;  // [WR][WOP] each, over the slices
  float* Pt = wsm + 4 * WR * WSP;         // P^T [key][query]
  float* St = Pt + WR * WSP;              // dS^T
  float *Ls = St + WR * WSP, *Dl = Ls + WR;
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv, group = H / Hkv;
  const int k0 = blockIdx.y * WR, c0 = blockIdx.z * WO;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  float dka[4][8], dva[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 8; ++w) dka[u][w] = dva[u][w] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + ((long long)b * S * H + h) * D;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = 0; qt < S; qt += WR) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) s[u][w] = dp[u][w] = 0.f;
      for (int d0 = 0; d0 < D; d0 += WS) {
        __syncthreads();
        load_rows_f32(Ks, WSP, kb, ks.s, k0, S, d0, D, WS);
        load_rows_f32(Vs, WSP, vb, vs.s, k0, S, d0, D, WS);
        load_rows_f32(Qs, WSP, qb, qs.s, qt, S, d0, D, WS);
        load_rows_f32(Ds, WSP, db, (long long)H * D, qt, S, d0, D, WS);
        if (d0 == 0 && threadIdx.x < WR) {
          const bool ok = qt + threadIdx.x < S;
          Ls[threadIdx.x] = ok ? lrow[qt + threadIdx.x] : CUDART_INF_F;   // p = 0
          Dl[threadIdx.x] = ok ? drow[qt + threadIdx.x] : 0.f;
        }
        __syncthreads();
        wide_dots(s, Ks, Qs, ty, tx);
        wide_dots(dp, Vs, Ds, ty, tx);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ty + u;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int col = 4 * tx + w;
          const float p = exp2f(s[u][w] * scale_log2 - Ls[col]);
          Pt[r * WSP + col] = round_to(p, T());
          St[r * WSP + col] = round_to(p * (dp[u][w] - Dl[col]), T());
        }
      }
      __syncthreads();
      load_rows_f32(Qv, WOP, qb, qs.s, qt, S, c0, D, WO);
      load_rows_f32(Dv, WOP, db, (long long)H * D, qt, S, c0, D, WO);
      __syncthreads();
      wide_accumulate(dva, Pt, Dv, ty, tx);
      wide_accumulate(dka, St, Qv, ty, tx);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = k0 + 4 * ty + u;
    if (row >= S) continue;
    const long long o = (((long long)b * S + row) * Hkv + hk) * D;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int c = c0 + tx + 16 * w;
      if (c < D) {
        dk[o + c] = T(dka[u][w] * scale);
        dv[o + c] = T(dva[u][w]);
      }
    }
  }
}

template <typename T>
int launch_bwd_wide(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* l, float* dl, void* dq, void* dk,
                    void* dv, int B, int S, int H, int Hkv, int D, Strides qs,
                    Strides ks, Strides vs, float scale_log2, float scale,
                    cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wide<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dt = static_cast<const T*>(dout);
  const long long rows = (long long)B * S * H;
  flash_bwd_delta_wide<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      dt, static_cast<const T*>(o), dl, S, H, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nd = (D + WO - 1) / WO, ns = (S + WR - 1) / WR;
  flash_bwd_dq_wide<T><<<dim3(B * H, ns, nd), 256, WIDE_DQ_SMEM, st>>>(
      qt, kt, vt, dt, l, dl, static_cast<T*>(dq), S, H, Hkv, D, qs, ks, vs, scale_log2,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_wide<T><<<dim3(B * Hkv, ns, nd), 256, WIDE_DKV_SMEM, st>>>(
      qt, kt, vt, dt, l, dl, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, D, qs,
      ks, vs, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int D>
struct LaunchBwd {
  template <typename... A>
  static int run(A... args) { return launch_bwd_d<D>(args...); }
};

}  // namespace

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
  if (D > MAX_D && D % 8 == 0)
    return dtype == 1 ? launch_bwd_wide<bf16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H,
                                              Hkv, D, qs, ks, vs, scale_log2, scale, st)
                      : launch_bwd_wide<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S,
                                               H, Hkv, D, qs, ks, vs, scale_log2, scale, st);
  return dispatch_head_dim<LaunchBwd>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                      S, H, Hkv, qs, ks, vs, scale_log2, scale,
                                      dtype, st);
}

// Grouped-query attention forward for Hopper (sm_90a):
//   out = softmax(Q K^T / sqrt(D)) V,  kv-head = head / (H / Hkv),
// with an optional base-2 row log-sum-exp m + log2(l) [B, H, S] for the
// backward (flash_attention_bwd.cu). Replaces the TPU kernels _attn_kernel
// and _attn_kernel_lse of gaot_tpu/ops/pallas/flash_attention.py
// (_flash_forward). Every kernel below is a template on the head dim D,
// built for every multiple of 8 from 8 to 128; head dims above 128 take
// flash_wide.cu's wgmma forward in bf16 and flash_wide_f32.cu's split-TF32
// one in fp32, with D at run time.
//
// bf16 (flash_fwd_bf16). What bounds it: one exp2 per score on the
// special-function units (16 per clock per SM), then the two products on
// the tensor cores; the [S, S] scores never leave the chip. The design:
// - One block per (batch * q-head, 128 queries): two warpgroups of 64 query
//   rows each; up to D = 64 two blocks share an SM. The blocks of one head
//   are neighbours in the grid, so its K and V are read from device memory
//   once. The Q rows stay in registers as wgmma A fragments.
// - K and V stream through a ring of three shared-memory stages of 64 keys,
//   filled by 16-byte cp.async: the copy of tile j + 1 is issued right after
//   the barrier that opens tile j, so it overlaps that tile's work. Keys
//   past S are zero-filled.
// - The tiles are kept in the wgmma core-matrix layout without swizzle (8
//   rows x 16 bytes contiguous, filled chunk by chunk), so K serves as the
//   K-major B operand of S = Q K^T and V, in its natural [key, D] layout, as
//   the MN-major (transposed) B operand of P V: no element-wise transpose.
//   At D % 16 == 8 the K rows are padded to the next k-step of 16 with a
//   zeroed 16-byte chunk (the Q fragment columns there are zero too).
// - Products on the tensor cores through wgmma with A in registers:
//   S is m64 x n64 x k16 over ceil(D / 16) k-steps; the S accumulator is, per
//   8 keys, the A fragment layout of P V, whose N = D is issued as wgmma
//   pieces of N = 128, 64, 32, 16, 8 (D = 24: 16 + 8).
// - Softmax off the products' path: S_j is issued together with the
//   previous tile's P_{j-1} V_{j-1}, and the softmax of S_j runs while that
//   product is still on the tensor cores; O is rescaled once it has landed.
//   fp32 running max (shuffled over the row's four threads) and a per-thread
//   partial denominator, reduced once at the end; one FFMA and one
//   ex2.approx.ftz per score (exp2(s c - m c) with c = scale log2 e); only
//   the ragged last tile is masked. P is rounded to bf16 before P V and the
//   output is divided by the fp32 denominator once at the end.
// fp32 (flash_fwd_f32). What bounds it: the 4 B H S^2 D fp32 operations
// on the CUDA cores (fp32 products stay fp32: no TF32), one exp2 a score
// beside them. The design (flash_f32.cuh): one block per (batch * q-head,
// ROWS queries), Q staged once in shared memory, K and V streamed in tiles
// of BT keys through a two-stage cp.async ring; per tile each warp builds
// S for its rows as register micro-tiles (8 queries x 8 keys a lane at
// D <= 32) from 16-byte shared-memory loads, runs the online softmax per
// row over the lanes that hold it (xor shuffles for the max; the
// denominator summed once at the end), and O += P V again as register
// micro-tiles, P passing through a shared tile of the warp's own.
// The wgmma, cp.async and descriptor helpers live in wgmma.cuh, shared with
// fused_ffn.cu. Plain C interface; each entry returns cudaGetLastError()
// after its launch.
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "wgmma.cuh"

namespace {

using namespace flash;
using namespace hopper;

template <int D>
struct FwdTile {
  static constexpr int BQW = 128;                 // queries per block
  static constexpr int THREADS = 2 * BQW;         // two warpgroups of 64 rows
  static constexpr int MINB = D <= 64 ? 2 : 1;    // blocks an SM must hold
  static constexpr int BKW = 64;                  // keys per tile
  static constexpr int NSTAGE = 3;                // K/V stages in the ring
  static constexpr int KSTEPS = (D + 15) / 16;    // k-steps of S over D
  static constexpr int DK8 = 2 * KSTEPS;          // 16-byte chunks of a K row
  static constexpr int D8 = D / 8;                // 16-byte chunks of a V row
  static constexpr int KGRP = DK8 * 128;          // bytes between 8-key groups of K
  static constexpr int VGRP = D8 * 128;           // the same of V
  static constexpr int KBYTES = BKW * DK8 * 16, STAGE = KBYTES + BKW * D8 * 16;
  static constexpr int SMEM = NSTAGE * STAGE;
  static_assert(D % 8 == 0 && D >= 8 && D <= MAX_D, "head dim must be a multiple of 8 from 8 to 128");
  static_assert(SMEM <= 232448, "flash forward stages exceed shared memory");
};

// P V for one k-step of 16 keys: the pieces of N = 128, 64, 32, 16, 8 that
// make up D, from column C0 on; o holds the D / 8 n-tiles of 4 values.
template <int D, int C0 = 0>
__device__ __forceinline__ void pv_pieces(float* o, const uint32_t a[4], uint32_t vaddr) {
  if constexpr (C0 < D) {
    constexpr int R = D - C0;
    constexpr int N = R >= 128 ? 128 : R >= 64 ? 64 : R >= 32 ? 32 : R >= 16 ? 16 : 8;
    Wgmma<N, 1>::run(o + C0 / 2, a,
                     smem_desc(vaddr + C0 / 8 * 128, FwdTile<D>::VGRP, 128), 1);
    pv_pieces<D, C0 + N>(o, a, vaddr);
  }
}

// Issues the cp.async copies of the K and V tile of keys kt .. kt + BKW - 1
// into one stage (not committed).
template <int D>
__device__ __forceinline__ void load_kv_tile(const bf16* kb, const bf16* vb,
                                             long long kss, long long vss,
                                             int kt, int S, uint32_t stage) {
  using T = FwdTile<D>;
  for (int i = threadIdx.x; i < T::BKW * T::D8; i += blockDim.x) {
    const int key = i / T::D8, c = i % T::D8;
    const bool ok = kt + key < S;
    const long long row = ok ? kt + key : 0;
    const uint32_t off = (key & 7) * 16 + c * 128;   // within the 8-key group
    cp_async16(stage + (key >> 3) * T::KGRP + off, kb + row * kss + c * 8, ok);
    cp_async16(stage + T::KBYTES + (key >> 3) * T::VGRP + off, vb + row * vss + c * 8, ok);
  }
}

// Up to D = 64 two blocks share an SM (registers capped at 128 a thread).
template <int D>
__global__ void __launch_bounds__(FwdTile<D>::THREADS, FwdTile<D>::MINB)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int S, int H, int Hkv, Strides qs,
               Strides ks, Strides vs, float scale_log2) {
  using T = FwdTile<D>;
  constexpr int BKW = T::BKW, NS = BKW / 2, NO = D / 2, NST = T::NSTAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // The query blocks of one head are neighbours in the grid, so its K and V
  // come from device memory once and from L2 after.
  const int nqb = (S + T::BQW - 1) / T::BQW;
  const int bh = blockIdx.x / nqb, qblk = blockIdx.x % nqb;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int ntiles = (S + BKW - 1) / BKW;

  // The zero pad chunk of every K row (D % 16 == 8), in every stage.
  if (T::DK8 != T::D8) {
    for (int i = threadIdx.x; i < NST * BKW; i += blockDim.x) {
      const int st = i / BKW, key = i % BKW;
      *reinterpret_cast<uint4*>(smem + st * T::STAGE + (key >> 3) * T::KGRP +
                                T::D8 * 128 + (key & 7) * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  load_kv_tile<D>(kb, vb, ks.s, vs.s, 0, S, sbase);
  cp_async_commit();

  // Warp w of warpgroup w / 4 owns rows 16 (w mod 4) .. + 15 of its 64.
  const int r0 = qblk * T::BQW + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int r1 = r0 + 8;
  const bf16* qb = q + b * qs.b + h * qs.h;
  uint32_t qa[T::KSTEPS][4];
#pragma unroll
  for (int st = 0; st < T::KSTEPS; ++st)
    load_a<D>(qa[st], qb + (long long)r0 * qs.s, qb + (long long)r1 * qs.s,
              r0 < S, r1 < S, st, t);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // Running max in unscaled score units, per-thread partial denominators.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  // P of the previous tile (bf16): the n-tiles 2kk and 2kk + 1 of its S
  // are the A fragment of the k-step kk of P V.
  uint32_t pa[BKW / 16][4];

  // Tile j: S_j = Q K_j^T is issued together with the previous tile's
  // O += P_{j-1} V_{j-1}; the softmax of S_j runs while P V is still on the
  // tensor cores, and O is rescaled once P V has landed.
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t stage = sbase + (j % NST) * T::STAGE;
    const uint32_t prev = sbase + ((j + NST - 1) % NST) * T::STAGE;
    const int kt = j * BKW;
    cp_async_wait_all();
    fence_proxy_async();
    // Tile j is in shared memory, and both warpgroups are done with tile
    // j - 2, whose stage the next copy overwrites.
    __syncthreads();
    if (j + 1 < ntiles)
      load_kv_tile<D>(kb, vb, ks.s, vs.s, kt + BKW, S, sbase + ((j + 1) % NST) * T::STAGE);
    cp_async_commit();

    float s[NS];
    wg_fence();
#pragma unroll
    for (int st = 0; st < T::KSTEPS; ++st)
      Wgmma<BKW, 0>::run(s, qa[st], smem_desc(stage + st * 256, 128, T::KGRP), st > 0);
    wg_commit();
    if (j > 0) {
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk)
        pv_pieces<D>(o, pa[kk], prev + T::KBYTES + 2 * kk * T::VGRP);
    }
    wg_commit();
    wg_wait<1>();   // S_j has landed; P_{j-1} V_{j-1} may still run
#pragma unroll
    for (int i = 0; i < NS; ++i) reg_fence(s[i]);

    if (kt + BKW > S) {   // the ragged last tile
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (kt + 8 * (i >> 2) + 2 * t + (i & 1) >= S) s[i] = -CUDART_INF_F;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BKW / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    const float a0 = ex2(m0 * scale_log2 - ms0), a1 = ex2(m1 * scale_log2 - ms1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BKW / 8; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -ms0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -ms0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -ms1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -ms1));
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;

    wg_wait<0>();   // P_{j-1} V_{j-1} has landed: O and pa are free
#pragma unroll
    for (int i = 0; i < NO; ++i) reg_fence(o[i]);
#pragma unroll
    for (int kk = 0; kk < BKW / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BKW / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
  // The last tile's P V.
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKW / 16; ++kk)
    pv_pieces<D>(o, pa[kk], sbase + ((ntiles - 1) % NST) * T::STAGE + T::KBYTES +
                                2 * kk * T::VGRP);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NO; ++i) reg_fence(o[i]);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * S + r0) * H + h) * D + c) =
          __floats2bfloat162_rn(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * S + r1) * H + h) * D + c) =
          __floats2bfloat162_rn(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[(long long)bh * S + r0] = m0 * scale_log2 + log2f(l0);
    if (r1 < S) lse[(long long)bh * S + r1] = m1 * scale_log2 + log2f(l1);
  }
}

// fp32 (the tiles and micro-tiles of flash_f32.cuh): one block per
// (batch * q-head, ROWS queries), the blocks of one head neighbours in the
// grid. Per tile of BT keys, each warp: S = Q K^T for its RW queries as
// R x KC micro-tiles, scaled by c = scale log2 e, the ragged last tile
// masked; the online softmax per row over the LC lanes that hold it
// (running max m of the scaled scores, rescale of O and of the per-lane
// partial denominator, p = exp2(s c - m) by ex2.approx: exp2f differs
// only where a result falls below 2^-126, too small to move a sum whose
// largest term is 1); P to the warp's shared tile;
// O += P V as R x D / LC micro-tiles. The epilogue sums the denominator
// over the row's lanes, divides once and writes the base-2 LSE
// m + log2(l).
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::Fwd::THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int S, int H, int Hkv, Strides qs,
              Strides ks, Strides vs, float scale_log2) {
  using G = typename F32Tile<D>::Fwd;
  constexpr int LD = G::LD, BT = G::BT, R = G::R, KC = G::KC, VW = G::VW;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                          // [ROWS][LD]
  float* ring = Qs + G::ROWS * LD;          // two stages of K, V [BT][LD]
  float* Pw = ring + 4 * BT * LD;           // a warp's P [RW][LP]

  const int nqb = (S + G::ROWS - 1) / G::ROWS;
  const int bh = blockIdx.x / nqb, q0 = blockIdx.x % nqb * G::ROWS;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane / G::LC, c = lane % G::LC;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int ntiles = (S + BT - 1) / BT;
  auto load = [&](int t) {
    float* st = ring + (t & 1) * 2 * BT * LD;
    f32_copy_rows<D, BT>(st, kb, ks.s, t * BT, S);
    f32_copy_rows<D, BT>(st + BT * LD, vb, vs.s, t * BT, S);
  };
  f32_copy_rows<D, G::ROWS>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load(0);
  hopper::cp_async_commit();

  const int wrow = warp * G::RW + r;        // this lane's first row in the block
  const float* qrow = Qs + wrow * LD;
  float* pw = Pw + warp * G::RW * G::LP + r * G::LP;
  float o[R][G::NO], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < G::NO; ++x) o[i][x] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    hopper::cp_async_wait_all();
    // Tile t is in shared memory, and every warp is done with tile t - 1,
    // whose stage the next copy overwrites.
    __syncthreads();
    if (t + 1 < ntiles) load(t + 1);
    hopper::cp_async_commit();
    const float* kt = ring + (t & 1) * 2 * BT * LD;
    const float* vt = kt + BT * LD;

    float s[R][KC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int x = 0; x < KC; ++x) s[i][x] = 0.f;
    f32_dots<G, D>(s, qrow, kt + c * LD);
#pragma unroll
    for (int x = 0; x < KC; ++x) {
      const bool in = t * BT + c + G::LC * x < S;   // the ragged last tile
#pragma unroll
      for (int i = 0; i < R; ++i) s[i][x] = in ? s[i][x] * scale_log2 : -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int x = 1; x < KC; ++x) mx = fmaxf(mx, s[i][x]);
      const float mn = fmaxf(m[i], f32_row_max<G::LC>(mx));   // finite: a tile holds a key
      const float alpha = ex2(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < KC; ++x) {
        s[i][x] = ex2(s[i][x] - mn);
        sum += s[i][x];
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int x = 0; x < G::NO; ++x) o[i][x] *= alpha;
    }
    f32_store_tile<G>(pw + c, s);
    f32_accumulate<G, D>(o, pw, vt, c);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + wrow + G::LR * i;
    const float den = f32_row_sum<G::LC>(l[i]);
    if (row >= S) continue;
    float* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int mm = 0; mm < G::NV; ++mm) {
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = o[i][mm * VW + w] / den;
      st_vec<VW>(orow + f32_col<G>(c, mm), x);
    }
    if (lse != nullptr && c == 0) lse[(long long)bh * S + row] = m[i] + log2f(den);
  }
}


template <int D>
struct LaunchFwd {
  static int run(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int H, int Hkv, Strides qs,
                 Strides ks, Strides vs, float scale_log2, int dtype,
                 cudaStream_t st) {
    if (dtype == 1) {
      using T = FwdTile<D>;
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
      if (err != cudaSuccess) return (int)err;
      const long long blocks = (long long)B * H * ((S + T::BQW - 1) / T::BQW);
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      flash_fwd_bf16<D><<<(unsigned)blocks, T::THREADS, T::SMEM, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, Hkv,
          qs, ks, vs, scale_log2);
    } else {
      using G = typename F32Tile<D>::Fwd;
      constexpr int smem = G::FWD_SMEM;
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      const long long blocks = (long long)B * H * ((S + G::ROWS - 1) / G::ROWS);
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      flash_fwd_f32<D><<<(unsigned)blocks, G::THREADS, smem, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, Hkv,
          qs, ks, vs, scale_log2);
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace

// q, k, v: [B, S, H or Hkv, D] with the given element strides (D
// contiguous, 16-byte aligned rows); out contiguous [B, S, H, D]; lse
// (optional) fp32 [B, H, S].
extern "C" int gaot_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int S, int H,
                              int Hkv, int D, long long qsb, long long qss,
                              long long qsh, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss,
                              long long vsh, float scale_log2, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_head_dim<LaunchFwd>(D, q, k, v, out, static_cast<float*>(lse),
                                      B, S, H, Hkv, qs, ks, vs, scale_log2, dtype, st);
}

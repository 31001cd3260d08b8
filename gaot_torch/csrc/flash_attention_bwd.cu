// Grouped-query attention backward for Hopper (sm_90a), bf16 and fp32, from
// the forward's base-2 row LSE; replaces the three regimes of the TPU
// backward in gaot_tpu/ops/pallas/flash_attention.py (_flash_backward at
// S <= 1024 and at S <= 4096, _flash_backward_long beyond). Every kernel
// is a template on the head dim D, instantiated for every multiple of 8
// from 8 to 128 (flash_common.cuh); head dims above 128 take flash_wide.cu's
// wgmma backward in bf16 and flash_wide_f32.cu's split-TF32 one in fp32,
// with D at run time. Plain C interface; the entry returns
// cudaGetLastError() after its launches.
//
// The arithmetic (the kv-tiled flash backward):
//   p = exp2(s * scale_log2 - lse)     normalised probabilities
//   delta = rowsum(dO * O)             fp32, once per row
//   dS = p * (dP - delta),  dP = dO V^T
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = p^T dO
// Two deterministic kernels, no float atomics: dQ with one block per
// (batch * q-head, query block) looping over the key tiles; dK/dV with one
// block per (batch * kv-head, key block) looping over the group's q-heads
// and every query tile, so the GQA group sum stays in fp32 registers. In
// bf16 p and dS are rounded to bf16 before their products, as the TPU
// kernels do. The recompute of S, dP and p in both kernels is the price of
// the determinism.
//
// bf16 (flash_bwd_dq_bf16, then flash_bwd_dkv_bf16). What bounds it on the
// card: 14 B H S^2 D operations on the tensor cores (S and dP in both
// kernels, dQ, dK, dV) and two exp2 per score on the special-function
// units, against a few bytes per score; at D = 24 and 32 it is latency:
// each 64-row tile is a short chain of products, exp2 and dS arithmetic, and
// only more warps in flight hide it (one block an SM ran far slower than
// two). The design:
// - Two warpgroups a block, each owning 64 rows of the block's resident side
//   (queries in dQ, keys in dK/dV), which stays in shared memory for the
//   whole block; up to D = 32 two blocks share an SM (registers capped at
//   128 a thread). The other side streams through a ring of NST stages of U
//   64-row sub-tiles (two stages of four up to D = 32: one barrier per 256
//   rows), filled by 16-byte cp.async (LSE and delta by 4-byte ones), the
//   next stages' copies issued right after the barrier that opens a stage,
//   so they run under its products. Rows past S are zero-filled, which makes
//   their terms vanish with no mask: a zero K/V row adds dS * 0 to dQ, and a
//   zero Q/dO row with LSE = delta = 0 gives p = 1, dS = 0 and adds p * 0 to
//   dV; sub-tiles wholly past S are skipped.
// - Every product is a wgmma over tiles in wgmma's swizzled layouts (rows of
//   the head dim padded to DP = 16, 32, 64 or 128 with zero 16-byte chunks,
//   swizzled over min(2 DP, 128) bytes; DP = 128 as two 64-column blocks).
//   Each tile serves twice with no transposed copy: K-major (K = head dim)
//   as an operand of the products over D, and through the descriptor's
//   transpose bit MN-major (K = rows, N = head dim) as B of the products
//   whose N is D.
//   dK/dV: S^T = K Q^T and dP^T = V dO^T with K and V (resident) as the A
//   and Q and dO (streamed) as the K-major B of m64 x nBQT; then dV += P^T dO
//   and dK += dS^T Q with P^T and dS^T from the accumulators as register A
//   fragments and dO and Q as MN-major B of N = D (DP where wgmma has no
//   such N).
//   dQ: S = Q K^T and dP = dO V^T (Q and dO resident, K and V streamed),
//   then dQ += dS K with dS from registers and K as MN-major B.
// - Per sub-tile the exp2 of S runs while dP is on the tensor cores; the
//   products whose N is D are waited for before the next sub-tile, as ptxas
//   serialises the wgmmas of a pipeline stage that spans a loop's back edge.
// - delta is computed by the dQ kernel, four threads a row, from O and dO,
//   and written for the dK/dV kernel, which runs after it: no launch of its
//   own.
// fp32 (flash_bwd_dq_f32, which also writes delta, then flash_bwd_dkv_f32).
// What bounds it: 10 B H S^2 D fp32 operations on the CUDA cores (fp32
// products stay fp32: no TF32); the two deterministic kernels do 14, S and
// dP in both, so at most 5 / 7 = 71% of that bound. The design
// (flash_f32.cuh): the resident side (Q and dO, or K and V) staged once in
// shared memory, the other side streamed through a two-stage cp.async ring;
// each warp builds S and dP for its rows as register micro-tiles from
// 16-byte shared-memory loads, p = exp2(s c - lse) (one FFMA and
// ex2.approx) and dS = p (dP - delta) in registers, then P and dS pass
// through a shared tile of the warp's own into dQ += dS K, or dV += P^T dO
// and dK += dS^T Q, again register micro-tiles. delta is computed by the
// dQ kernel (no launch of its own), over d in the order of dP's sums.
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "wgmma.cuh"

namespace {

using namespace flash;
using namespace hopper;

// ---------------------------------------------------------------------------
// bf16 on wgmma. A tile of R rows of the head dim, padded to DP, in wgmma's
// swizzled layout: row r's 16-byte chunk c (of DP / 8) sits in column block
// c / CPR, at r * SW + ((c mod CPR) ^ ((r SW / 128) mod CPR)) * 16 within
// it; the blocks lie R * SW bytes apart. Read K-major, 8-row groups lie
// 8 SW apart; read MN-major, the same bytes are atoms of 8 rows (K) x SW / 2
// columns (N), 8-row groups 8 SW apart, column blocks R SW apart.
template <int D>
struct BwdTile {
  static constexpr int DP = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
  static constexpr int SW = DP >= 64 ? 128 : 2 * DP;    // swizzle span, bytes
  static constexpr int CPR = SW / 16;                   // chunks of a swizzled row
  static constexpr uint64_t TYPE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int KSTEPS = (D + 15) / 16;          // k-steps over D
  // N of the products whose N is the head dim: D itself at D = 8 and 24
  // (the first columns of the swizzled atom; at D = 24 faster than N = 32),
  // DP otherwise.
  static constexpr int NDP = D % 16 == 8 && D < 32 ? D : DP;
  static constexpr int WGS = 2;                         // warpgroups a block
  static constexpr int THREADS = 128 * WGS;
  static constexpr int ROWS = 64 * WGS;                 // resident rows a block
  static constexpr int RES = ROWS * 2 * DP;             // bytes of a resident tile
  // Two blocks an SM up to DP = 32 (registers capped at 128 a thread).
  static constexpr int MINB = DP <= 32 ? 2 : 1;
  // Streamed rows of a sub-tile: the dK/dV kernel's queries (its S^T is
  // 64 x BQT; at DP = 128 the dK and dV accumulators take 128 registers a
  // thread), and the dQ kernel's keys. A stage of the ring holds U
  // sub-tiles, taken one after the other between two barriers: up to
  // DP = 32 four sub-tiles in two stages (a barrier per 256 rows, and two
  // blocks an SM still fit), above it one in four.
  static constexpr int BQT = DP > 64 ? 32 : 64;
  static constexpr int BKT = 64;
  static constexpr int U = DP > 32 ? 1 : 4;
  static constexpr int NST = DP > 32 ? 4 : 2;           // stages of the ring
  static constexpr int P = NST - 1;                     // stages copied ahead
  // A stage: the two streamed tiles of U sub-tiles, then (dK/dV) LSE and
  // delta, rounded up to the 1024-byte boundary of the swizzle atoms.
  static constexpr int QROWS = U * BQT, KROWS = U * BKT;
  static constexpr int QSTAGE = (2 * QROWS * 2 * DP + 2 * QROWS * 4 + 1023) / 1024 * 1024;
  static constexpr int KSTAGE = 2 * KROWS * 2 * DP;
  static constexpr int DKV_SMEM = 2 * RES + NST * QSTAGE + 1024;
  static constexpr int DQ_SMEM = 2 * RES + NST * KSTAGE + 1024;
  static_assert(D % 8 == 0 && D >= 8 && D <= MAX_D, "head dim must be a multiple of 8 from 8 to 128");
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "backward stages exceed shared memory");

  static __device__ __forceinline__ uint32_t off(int R, int r, int c) {
    return (c / CPR) * R * SW + r * SW + (((c % CPR) ^ ((r * SW >> 7) & (CPR - 1))) << 4);
  }
  // K-major piece of a tile of R rows: rows row0 .. row0 + 63 (A) or
  // row0 .. row0 + N - 1 (B), the 16 columns of k-step st.
  static __device__ __forceinline__ uint64_t kdesc(uint32_t tile, int R, int row0, int st) {
    const int byte = 32 * st;
    return smem_desc(tile + byte / SW * R * SW + row0 * SW + byte % SW, 16, 8 * SW) | TYPE << 62;
  }
  // MN-major piece of a tile of R rows: rows (K) k0 .. k0 + 15, its
  // columns (N) from 0.
  static __device__ __forceinline__ uint64_t mndesc(uint32_t tile, int R, int k0) {
    return smem_desc(tile + k0 * SW, R * SW, 8 * SW) | TYPE << 62;
  }
};

// cp.async of rows r0 .. r0 + R - 1 of a [*, D] operand (row stride rs) into
// a tile; rows past S and the pad chunks past D are zero-filled.
template <int D, int R>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* base, long long rs,
                                          int r0, int S) {
  using T = BwdTile<D>;
  constexpr int C = T::DP / 8;
  for (int i = threadIdx.x; i < R * C; i += T::THREADS) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < S && c < D / 8;
    cp_async16(dst + T::off(R, r, c), ok ? base + (long long)(r0 + r) * rs + 8 * c : base, ok);
  }
}

// The two products over D of one sub-tile, each committed as a group of its
// own: s = A1 B1^T and dp = A2 B2^T, A this warpgroup's 64 rows of the
// resident tiles a1, a2, B the N streamed rows from brow of tiles b1, b2 of
// R rows.
template <int D, int R, int N>
__device__ __forceinline__ void mma_over_d(float* s, float* dp, uint32_t a1, uint32_t a2,
                                           uint32_t b1, uint32_t b2, int arow, int brow) {
  using T = BwdTile<D>;
  wg_fence();
#pragma unroll
  for (int st = 0; st < T::KSTEPS; ++st)
    WgmmaSS<N, 0, 0>::run(s, T::kdesc(a1, T::ROWS, arow, st), T::kdesc(b1, R, brow, st), st > 0);
  wg_commit();
#pragma unroll
  for (int st = 0; st < T::KSTEPS; ++st)
    WgmmaSS<N, 0, 0>::run(dp, T::kdesc(a2, T::ROWS, arow, st), T::kdesc(b2, R, brow, st), st > 0);
  wg_commit();
}

// acc += A . B for KS k-steps of a product whose N is the head dim (NDP):
// A from registers, B the MN-major rows k0 .. k0 + 16 KS - 1 of a tile of
// R rows.
template <int D, int R, int KS>
__device__ __forceinline__ void mma_n_dp(float* acc, const uint32_t (*a)[4], uint32_t tile,
                                         int k0) {
  using T = BwdTile<D>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    Wgmma<T::NDP, 1>::run(acc, a[kk], T::mndesc(tile, R, k0 + 16 * kk), 1);
}

// dQ, and delta for the dK/dV kernel: one block per (batch * q-head, ROWS
// queries); the blocks of one head are neighbours in the grid, so its K and
// V come from device memory once and from L2 after.
template <int D>
__global__ void __launch_bounds__(BwdTile<D>::THREADS, BwdTile<D>::MINB)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const bf16* __restrict__ o, const float* __restrict__ lse,
                  float* __restrict__ delta, bf16* __restrict__ dq, int S, int H,
                  int Hkv, Strides qs, Strides ks, Strides vs, float scale_log2,
                  float scale) {
  using T = BwdTile<D>;
  constexpr int BKT = T::BKT, KROWS = T::KROWS, NST = T::NST, P = T::P;
  constexpr int NS = BKT / 2, NO = T::NDP / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qres = smem_base_1k(smem), dres = qres + T::RES;
  const uint32_t ring = dres + T::RES;

  const int nqb = (S + T::ROWS - 1) / T::ROWS;
  const int bh = blockIdx.x / nqb, q0 = blockIdx.x % nqb * T::ROWS;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long drs = (long long)H * D;      // row stride of dout and o
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const bf16* db = dout + ((long long)b * S * H + h) * D;
  const bf16* ob = o + ((long long)b * S * H + h) * D;
  const int nstages = (S + KROWS - 1) / KROWS;

  copy_rows<D, T::ROWS>(qres, q + b * qs.b + h * qs.h, qs.s, q0, S);
  copy_rows<D, T::ROWS>(dres, db, drs, q0, S);
  auto load = [&](int j) {
    const uint32_t st = ring + (j % NST) * T::KSTAGE;
    copy_rows<D, KROWS>(st, kb, ks.s, j * KROWS, S);
    copy_rows<D, KROWS>(st + KROWS * 2 * T::DP, vb, vs.s, j * KROWS, S);
  };
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nstages) load(i);
    cp_async_commit();   // the resident tiles join stage 0's group
  }

  // This thread's rows r0, r0 + 8: their LSE, and delta = rowsum(dO O) from
  // device memory, the row's four threads taking every fourth 8-column chunk.
  const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
  float dl[2], ls[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r1 : r0;
    float acc = 0.f;
    if (r < S) {
      for (int c = t; c < D / 8; c += 4) {
        const uint4 a = *reinterpret_cast<const uint4*>(db + r * drs + 8 * c);
        const uint4 e = *reinterpret_cast<const uint4*>(ob + r * drs + 8 * c);
        const bf16* ap = reinterpret_cast<const bf16*>(&a);
        const bf16* ep = reinterpret_cast<const bf16*>(&e);
#pragma unroll
        for (int x = 0; x < 8; ++x) acc += __bfloat162float(ap[x]) * __bfloat162float(ep[x]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[i] = acc;
    ls[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    if (t == 0 && r < S) delta[(long long)bh * S + r] = acc;
  }

  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;
  uint32_t da[BKT / 16][4];

  for (int j = 0; j < nstages; ++j) {
    const uint32_t st = ring + (j % NST) * T::KSTAGE, vt = st + KROWS * 2 * T::DP;
    cp_async_wait<P - 1>();
    fence_proxy_async();
    // Stage j is in shared memory, and both warpgroups are done with stage
    // j - 1, the one the next copy overwrites.
    __syncthreads();
    if (j + P < nstages) load(j + P);
    cp_async_commit();

#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      if (u > 0 && j * KROWS + u * BKT >= S) break;   // keys past S add nothing
      float s[NS], dp[NS];
      mma_over_d<D, KROWS, BKT>(s, dp, qres, dres, st, vt, 64 * wg, u * BKT);
      wg_wait<1>();   // S has landed
      fence_all<NS>(s);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = ex2(fmaf(s[i], scale_log2, -ls[(i >> 1) & 1]));
      wg_wait<0>();   // dP has landed
      fence_all<NS>(dp);
#pragma unroll
      for (int i = 0; i < NS; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
      to_a_frags<BKT>(da, dp);
      fence_all<NO>(dqa);
      wg_fence();
      mma_n_dp<D, KROWS, BKT / 16>(dqa, da, st, u * BKT);   // dQ += dS K
      wg_commit();
      // No product stays in flight into the next sub-tile: ptxas serialises
      // the wgmmas of a pipeline stage that spans the loop's back edge, and
      // the registers of a second one do not fit.
      wg_wait<0>();
      fence_all<BKT / 16>(da);
    }
  }
  fence_all<NO>(dqa);

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * S + r0) * H + h) * D + c) =
          pack_bf16(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * S + r1) * H + h) * D + c) =
          pack_bf16(dqa[4 * n + 2] * scale, dqa[4 * n + 3] * scale);
  }
}

// dK and dV: one block per (batch * kv-head, ROWS keys), looping over the
// group's q-heads and every stage of QROWS queries; the blocks of one
// kv-head are neighbours in the grid. Runs after flash_bwd_dq_bf16, which
// writes delta.
template <int D>
__global__ void __launch_bounds__(BwdTile<D>::THREADS, BwdTile<D>::MINB)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                   int Hkv, Strides qs, Strides ks, Strides vs, float scale_log2,
                   float scale) {
  using T = BwdTile<D>;
  constexpr int BQT = T::BQT, QROWS = T::QROWS, NST = T::NST, P = T::P;
  constexpr int NS = BQT / 2, NO = T::NDP / 2;
  constexpr int TILE = QROWS * 2 * T::DP;        // bytes of a streamed tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t kres = smem_base_1k(smem), vres = kres + T::RES;
  const uint32_t ring = vres + T::RES;
  // The generic address of the ring, for the LSE and delta reads.
  const unsigned char* gring =
      smem + (ring - static_cast<uint32_t>(__cvta_generic_to_shared(smem)));

  const int nkb = (S + T::ROWS - 1) / T::ROWS;
  const int bkv = blockIdx.x / nkb, k0 = blockIdx.x % nkb * T::ROWS;
  const int b = bkv / Hkv, hk = bkv % Hkv, group = H / Hkv;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long drs = (long long)H * D;
  const int nqs = (S + QROWS - 1) / QROWS, nstages = group * nqs;

  copy_rows<D, T::ROWS>(kres, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  copy_rows<D, T::ROWS>(vres, v + b * vs.b + hk * vs.h, vs.s, k0, S);
  // Stage j: q-head hk * group + j / nqs, queries (j mod nqs) * QROWS on;
  // its LSE and delta after the two tiles (zero past S).
  auto load = [&](int j) {
    const int h = hk * group + j / nqs, qt = j % nqs * QROWS;
    const uint32_t st = ring + (j % NST) * T::QSTAGE;
    copy_rows<D, QROWS>(st, q + b * qs.b + h * qs.h, qs.s, qt, S);
    copy_rows<D, QROWS>(st + TILE, dout + ((long long)b * S * H + h) * D, drs, qt, S);
    const long long row = ((long long)b * H + h) * S;
    for (int i = threadIdx.x; i < 2 * QROWS; i += T::THREADS) {
      const int c = i % QROWS;
      const bool ok = qt + c < S;
      cp_async4(st + 2 * TILE + 4 * i, (i < QROWS ? lse : delta) + row + (ok ? qt + c : 0), ok);
    }
  };
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nstages) load(i);
    cp_async_commit();   // the resident tiles join stage 0's group
  }

  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  uint32_t pa[BQT / 16][4], sa[BQT / 16][4];

  for (int j = 0; j < nstages; ++j) {
    const uint32_t st = ring + (j % NST) * T::QSTAGE;
    const float* lq = reinterpret_cast<const float*>(gring + (j % NST) * T::QSTAGE + 2 * TILE);
    cp_async_wait<P - 1>();
    fence_proxy_async();
    // Stage j is in shared memory, and both warpgroups are done with stage
    // j - 1, the one the next copy overwrites.
    __syncthreads();
    if (j + P < nstages) load(j + P);
    cp_async_commit();

#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      if (u > 0 && j % nqs * QROWS + u * BQT >= S) break;   // queries past S add nothing
      float s[NS], dp[NS];
      mma_over_d<D, QROWS, BQT>(s, dp, kres, vres, st, st + TILE, 64 * wg, u * BQT);
      wg_wait<1>();   // S^T has landed
      fence_all<NS>(s);
      // Column 8n + 2t + e of S^T is query u BQT + 8n + 2t + e of the stage.
      const float* lu = lq + u * BQT + 2 * t;
#pragma unroll
      for (int n = 0; n < BQT / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lu + 8 * n);
        s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -l2.x));
        s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -l2.y));
        s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -l2.x));
        s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -l2.y));
      }
      wg_wait<0>();   // dP^T has landed
      fence_all<NS>(dp);
#pragma unroll
      for (int n = 0; n < BQT / 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(lu + QROWS + 8 * n);
        dp[4 * n] = s[4 * n] * (dp[4 * n] - d2.x);
        dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - d2.y);
        dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - d2.x);
        dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - d2.y);
      }
      to_a_frags<BQT>(pa, s);
      to_a_frags<BQT>(sa, dp);
      fence_all<NO>(dva);
      fence_all<NO>(dka);
      wg_fence();
      mma_n_dp<D, QROWS, BQT / 16>(dva, pa, st + TILE, u * BQT);   // dV += P^T dO
      mma_n_dp<D, QROWS, BQT / 16>(dka, sa, st, u * BQT);          // dK += dS^T Q
      wg_commit();
      // No product stays in flight into the next sub-tile (see the dQ kernel).
      wg_wait<0>();
      fence_all<BQT / 16>(pa);
      fence_all<BQT / 16>(sa);
    }
  }
  fence_all<NO>(dka);
  fence_all<NO>(dva);

  const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < S) {
      const long long o = (((long long)b * S + r0) * Hkv + hk) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[4 * n] * scale, dka[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[4 * n], dva[4 * n + 1]);
    }
    if (r1 < S) {
      const long long o = (((long long)b * S + r1) * Hkv + hk) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }
}

// fp32 (the tiles and micro-tiles of flash_f32.cuh). dQ, and delta for the
// dK/dV kernel: one block per (batch * q-head, ROWS queries), the blocks of
// one head neighbours in the grid. delta = rowsum(dO O) of its rows first,
// summed over d in order as dP's terms are (at S = 1, O = V and dS is 0);
// then per tile of BT keys, each warp: S = Q K^T and dP = dO V^T for its
// RW queries as R x KC micro-tiles, p = exp2(s c - lse), dS = p (dP - delta)
// (zero for keys past S), dS to the warp's shared tile, dQ += dS K as
// R x D / LC micro-tiles; dQ times the scale at the end.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::Dq::THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ o, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int S, int H,
                 int Hkv, Strides qs, Strides ks, Strides vs, float scale_log2,
                 float scale) {
  using G = typename F32Tile<D>::Dq;
  constexpr int LD = G::LD, BT = G::BT, R = G::R, KC = G::KC, VW = G::VW;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                          // [ROWS][LD]
  float* Ds = Qs + G::ROWS * LD;            // dO [ROWS][LD]
  float* ring = Ds + G::ROWS * LD;          // two stages of K, V [BT][LD]
  float* Sw = ring + 4 * BT * LD;           // a warp's dS [RW][LP]

  const int nqb = (S + G::ROWS - 1) / G::ROWS;
  const int bh = blockIdx.x / nqb, q0 = blockIdx.x % nqb * G::ROWS;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane / G::LC, c = lane % G::LC;
  const long long drs = (long long)H * D;   // row stride of dout and o
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const float* db = dout + ((long long)b * S * H + h) * D;
  const float* ob = o + ((long long)b * S * H + h) * D;
  const int ntiles = (S + BT - 1) / BT;
  auto load = [&](int t) {
    float* st = ring + (t & 1) * 2 * BT * LD;
    f32_copy_rows<D, BT>(st, kb, ks.s, t * BT, S);
    f32_copy_rows<D, BT>(st + BT * LD, vb, vs.s, t * BT, S);
  };
  f32_copy_rows<D, G::ROWS>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  f32_copy_rows<D, G::ROWS>(Ds, db, drs, q0, S);
  load(0);
  hopper::cp_async_commit();

  // This lane's rows: their LSE, and delta from device memory, under the
  // copies (every lane of a row sums the whole row).
  const int wrow = warp * G::RW + r;
  float ls[R], dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + wrow + G::LR * i;
    float acc = 0.f;
    ls[i] = 0.f;
    if (row < S) {
      ls[i] = lse[(long long)bh * S + row];
      const float* x = db + row * drs;
      const float* y = ob + row * drs;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(x + d);
        const float4 e = *reinterpret_cast<const float4*>(y + d);
        acc = fmaf(a.x, e.x, acc);
        acc = fmaf(a.y, e.y, acc);
        acc = fmaf(a.z, e.z, acc);
        acc = fmaf(a.w, e.w, acc);
      }
      if (c == 0) delta[(long long)bh * S + row] = acc;
    }
    dl[i] = acc;
  }

  const float* qrow = Qs + wrow * LD;
  const float* drow = Ds + wrow * LD;
  float* sw = Sw + warp * G::RW * G::LP + r * G::LP;
  float acc[R][G::NO];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int x = 0; x < G::NO; ++x) acc[i][x] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    hopper::cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles) load(t + 1);
    hopper::cp_async_commit();
    const float* kt = ring + (t & 1) * 2 * BT * LD;
    const float* vt = kt + BT * LD;

    float s[R][KC], dp[R][KC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int x = 0; x < KC; ++x) s[i][x] = dp[i][x] = 0.f;
    f32_dots<G, D>(s, qrow, kt + c * LD);
    f32_dots<G, D>(dp, drow, vt + c * LD);
#pragma unroll
    for (int x = 0; x < KC; ++x) {
      const bool in = t * BT + c + G::LC * x < S;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = ex2(fmaf(s[i][x], scale_log2, -ls[i]));
        s[i][x] = in ? p * (dp[i][x] - dl[i]) : 0.f;
      }
    }
    f32_store_tile<G>(sw + c, s);
    f32_accumulate<G, D>(acc, sw, kt, c);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + wrow + G::LR * i;
    if (row >= S) continue;
    float* orow = dq + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int mm = 0; mm < G::NV; ++mm) {
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = acc[i][mm * VW + w] * scale;
      st_vec<VW>(orow + f32_col<G>(c, mm), x);
    }
  }
}

// dK, dV: one block per (batch * kv-head, ROWS keys), looping over the
// group's q-heads and every tile of BT queries (one ring across them), so
// the GQA group sum stays in fp32 registers. Per tile, each warp:
// S^T = K Q^T and dP^T = V dO^T for its RW keys, p from the queries' LSE,
// dS = p (dP - delta); then P to the warp's shared tile and dV += P^T dO,
// then dS to the same tile and dK += dS^T Q. Queries past S are zero rows
// with LSE and delta zero, whose terms vanish.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::Dkv::THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                  int Hkv, Strides qs, Strides ks, Strides vs,
                  float scale_log2, float scale) {
  using G = typename F32Tile<D>::Dkv;
  constexpr int LD = G::LD, BT = G::BT, R = G::R, KC = G::KC, VW = G::VW;
  constexpr int STAGE = 2 * BT * LD + 2 * BT;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                          // [ROWS][LD]
  float* Vs = Ks + G::ROWS * LD;
  float* ring = Vs + G::ROWS * LD;          // two stages of Q, dO [BT][LD], LSE, delta [BT]
  float* Pw = ring + 2 * STAGE;             // a warp's P, then dS [RW][LP]

  const int nkb = (S + G::ROWS - 1) / G::ROWS;
  const int bkv = blockIdx.x / nkb, k0 = blockIdx.x % nkb * G::ROWS;
  const int b = bkv / Hkv, hk = bkv % Hkv, group = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane / G::LC, c = lane % G::LC;
  const long long drs = (long long)H * D;
  const int ntiles = (S + BT - 1) / BT, total = group * ntiles;
  auto load = [&](int t) {
    const int h = hk * group + t / ntiles, r0 = t % ntiles * BT;
    float* st = ring + (t & 1) * STAGE;
    f32_copy_rows<D, BT>(st, q + b * qs.b + h * qs.h, qs.s, r0, S);
    f32_copy_rows<D, BT>(st + BT * LD, dout + ((long long)b * S * H + h) * D, drs, r0, S);
    f32_copy_vals(st + 2 * BT * LD, lse + ((long long)b * H + h) * S, r0, BT, S);
    f32_copy_vals(st + 2 * BT * LD + BT, delta + ((long long)b * H + h) * S, r0, BT, S);
  };
  f32_copy_rows<D, G::ROWS>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  f32_copy_rows<D, G::ROWS>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, S);
  load(0);
  hopper::cp_async_commit();

  const int wrow = warp * G::RW + r;
  const float* krow = Ks + wrow * LD;
  const float* vrow = Vs + wrow * LD;
  float* pw = Pw + warp * G::RW * G::LP + r * G::LP;
  float dka[R][G::NO], dva[R][G::NO];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int x = 0; x < G::NO; ++x) dka[i][x] = dva[i][x] = 0.f;

  for (int t = 0; t < total; ++t) {
    hopper::cp_async_wait_all();
    __syncthreads();
    if (t + 1 < total) load(t + 1);
    hopper::cp_async_commit();
    const float* qt = ring + (t & 1) * STAGE;
    const float* dt = qt + BT * LD;
    const float* lt = dt + BT * LD;
    const float* et = lt + BT;

    float s[R][KC], dp[R][KC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int x = 0; x < KC; ++x) s[i][x] = dp[i][x] = 0.f;
    f32_dots<G, D>(s, krow, qt + c * LD);
    f32_dots<G, D>(dp, vrow, dt + c * LD);
#pragma unroll
    for (int x = 0; x < KC; ++x) {
      const float lq = lt[c + G::LC * x], eq = et[c + G::LC * x];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = ex2(fmaf(s[i][x], scale_log2, -lq));
        s[i][x] = p;
        dp[i][x] = p * (dp[i][x] - eq);
      }
    }
    f32_store_tile<G>(pw + c, s);
    f32_accumulate<G, D>(dva, pw, dt, c);
    f32_store_tile<G>(pw + c, dp);
    f32_accumulate<G, D>(dka, pw, qt, c);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + wrow + G::LR * i;
    if (row >= S) continue;
    const long long off = (((long long)b * S + row) * Hkv + hk) * D;
#pragma unroll
    for (int mm = 0; mm < G::NV; ++mm) {
      float x[VW], y[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        x[w] = dka[i][mm * VW + w] * scale;
        y[w] = dva[i][mm * VW + w];
      }
      st_vec<VW>(dk + off + f32_col<G>(c, mm), x);
      st_vec<VW>(dv + off + f32_col<G>(c, mm), y);
    }
  }
}

template <int D>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* l, float* dl, void* dq, void* dk,
               void* dv, int B, int S, int H, int Hkv, Strides qs, Strides ks,
               Strides vs, float scale_log2, float scale, int dtype,
               cudaStream_t st) {
  if (dtype == 1) {
    using T = BwdTile<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    const long long blk = (S + T::ROWS - 1) / T::ROWS;
    if ((long long)B * H * blk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
    flash_bwd_dq_bf16<D><<<(unsigned)(B * H * blk), T::THREADS, T::DQ_SMEM, st>>>(
        qb, kb, vb, db, static_cast<const bf16*>(o), l, dl, static_cast<bf16*>(dq), S, H,
        Hkv, qs, ks, vs, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_bf16<D><<<(unsigned)(B * Hkv * blk), T::THREADS, T::DKV_SMEM, st>>>(
        qb, kb, vb, db, l, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, Hkv,
        qs, ks, vs, scale_log2, scale);
  } else {
    using T = F32Tile<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::Dq::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::Dkv::DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    const long long bq = (S + T::Dq::ROWS - 1) / T::Dq::ROWS;
    const long long bk = (S + T::Dkv::ROWS - 1) / T::Dkv::ROWS;
    if ((long long)B * H * bq > 0x7fffffffLL || (long long)B * Hkv * bk > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    flash_bwd_dq_f32<D><<<(unsigned)(B * H * bq), T::Dq::THREADS, T::Dq::DQ_SMEM, st>>>(
        qf, kf, vf, df, static_cast<const float*>(o), l, dl, static_cast<float*>(dq), S, H,
        Hkv, qs, ks, vs, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32<D><<<(unsigned)(B * Hkv * bk), T::Dkv::THREADS, T::Dkv::DKV_SMEM, st>>>(
        qf, kf, vf, df, l, dl, static_cast<float*>(dk), static_cast<float*>(dv), S, H, Hkv,
        qs, ks, vs, scale_log2, scale);
  }
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
  return dispatch_head_dim<LaunchBwd>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B,
                                      S, H, Hkv, qs, ks, vs, scale_log2, scale,
                                      dtype, st);
}

// Grouped-query attention at head dims above 128 (any multiple of 8, D at
// run time), fp32, for Hopper (sm_90a): the forward (with and without the
// base-2 row LSE) and the backward (dQ, which also writes delta, then
// dK/dV), every product on the tensor cores as split-TF32 wgmmas. Replaces,
// for D > 128 in fp32, the TPU kernels of gaot_tpu/ops/pallas/
// flash_attention.py that the templated kernels of flash_attention.cu and
// flash_attention_bwd.cu replace for D <= 128: _attn_kernel and
// _attn_kernel_lse (_flash_forward), and the backward of all three regimes
// (_attn_bwd_kernel, _attn_bwd_tiled_kernel, _bwd_dq_kernel /
// _bwd_dkv_kernel). The arithmetic outside the products is the templated
// fp32 kernels': fp32 scores, running max and sum, exp2 with the base-2
// LSE; the backward takes p from the saved LSE and applies the scale at the
// end of dQ and dK, as _flash_backward_long does. Deterministic: no float
// atomics.
//
// Split TF32: each operand x is held as hi = tf32(x) and lo = tf32(x - hi)
// (rounded to nearest, ties away, as cvt.rna does), and each product A B
// as A_lo B_hi + A_hi B_lo + A_hi B_hi, three tf32 wgmmas with fp32
// accumulators. What that leaves out, A_lo B_lo, is about 2^-22 of A B, so
// the results stay fp32 to fp32's own rounding, with no switch (TF32 stays
// off for the library's products).
//
// What bounds it: the function's bound is the products, 4 B H S^2 D
// operations forward and 10 backward, each run three times on the TF32
// tensor cores (495 TFLOP/s dense on the H100: 2.5x the fp32 rate of the
// CUDA cores after the three passes). The split doubles every operand in
// shared memory, which leaves no room to keep a side resident: each tile of
// the other side streams the block's own rows again, and a block owns one
// slice of its outputs' head dim (a grid dimension) and recomputes the
// scores, and in the backward dP, over the full D for it (slices of 256 in
// the forward and dQ, of 128 in dK/dV: registers hold the outputs). On the
// card the staging (copies, split, transposed stores) and the wgmmas' reads
// of both operands from shared memory bound the kernels, more than the
// products: taking the products out left most of the time.
// The design:
// - Two consumer warpgroups a block, 64 rows each of the block's 128
//   (queries in the forward and dQ, keys in dK/dV); every thread issues
//   16-byte cp.async copies.
// - Every operand streams through a ring of NST stages, one "item" a stage:
//   a "chunk" item is a 32-column chunk of the head dim of the block's 128
//   rows and of the other side's 64-row tile (the products over D: S = Q K^T,
//   dP = dO V^T and their transposes); a "piece" item is 64 columns of the
//   other side's tile for the products whose N is the head dim (O += P V,
//   dQ += dS K, dV += P^T dO, dK += dS^T Q).
// - A tf32 wgmma reads both shared-memory operands K-major. A chunk tile is
//   K-major as it lies in device memory: its copies land in wgmma's 128-byte
//   swizzled layout (a row's 128 bytes = 32 fp32 columns, eight threads to a
//   row), and each thread then rounds its own 16-byte pieces in place to hi
//   and writes lo to a tile of the same layout. A piece lands raw (rows of
//   256 bytes, 16-byte chunks swizzled over the row) and each thread writes
//   its own pieces transposed ([column][row], the rows K-major in two blocks
//   of 32) as hi and lo, the scalar stores of a warp on 32 distinct banks.
//   Columns past D and rows past S are zero-filled; the k-steps of 8 past D
//   are skipped.
// - The copies of item i + NST are issued right after the barrier that
//   closes item i; the split of item i + 1 runs while item i's wgmmas run.
// - Each item's products go to a fresh accumulator, which one rounded fp32
//   add a value takes into the running sums (S and dP over D, O, dQ, dK
//   and dV over the rows): a wgmma's additions into its accumulator are
//   not rounded to nearest, and one accumulator over all of D = 8192
//   drifted out of the card's widths check.
// - P and dS (P^T and dS^T in dK/dV) leave the accumulators through a
//   64 x 64 hi and lo tile of each warpgroup in shared memory, the A
//   operand of the products whose N is the head dim.
// - The forward: S (64 queries x 64 keys a warpgroup) over the D chunks,
//   the online softmax (fp32 running max over the row's four threads, one
//   FFMA and one ex2.approx a score, the ragged last key tile masked), then
//   O += P V for the slice's pieces of 64 columns. The epilogue divides by
//   the denominator and writes the LSE from slice 0 only.
// - dQ: delta = rowsum(dO O) of the block's rows in fp32 at the start (four
//   threads a row; slice 0 writes it for dK/dV); S of 64 keys over D and
//   p = exp2(s c - lse), zero past S, to the tile; dP over D and dS =
//   p (dP - delta) over p in the tile; dQ += dS K. S and dP never share the
//   registers, which hold dQ's 128 a thread.
// - dK/dV: one block per (batch * kv-head, 128 keys, slice), looping over
//   the group's q-heads and every tile of 64 queries in a fixed order, so the
//   GQA group sum stays in fp32 registers. S^T over D and P^T to the tile
//   (the LSE from the tail of the last chunk's stage); dV += P^T dO; dP^T
//   over D and dS^T = p (dP^T - delta) over P^T in the tile; dK += dS^T Q.
// Plain C interface; each entry returns cudaGetLastError() after its
// launches.
#include "flash_common.cuh"
#include "tf32_split.cuh"

namespace {

using namespace flash;
using namespace hopper;
using namespace tf32;

constexpr int THREADS = 256;           // two warpgroups
constexpr int CHUNK = 32;              // fp32 columns of a chunk tile: one 128-byte row
constexpr int ROWS = 128;              // rows of a block
constexpr int TILE_ROWS = 64;          // rows of the other side's tile
constexpr int PIECE = 64;              // columns of a piece
constexpr int NST = 3;                 // stages of the ring
constexpr int BIG = ROWS * ROW_BYTES;          // 16 KB: a chunk tile of the block's rows
constexpr int SMALL = TILE_ROWS * ROW_BYTES;   // 8 KB: a chunk tile of the other side's
constexpr int ITEM = 2 * BIG + 2 * SMALL;      // 48 KB: hi and lo of both
constexpr int TAIL = 1024;                     // dK/dV: a query tile's LSE and delta
constexpr int PTILE = 2 * BIG;                 // a warpgroup's P or dS: 64 x 64, hi and lo
constexpr int SMEM_MAX = 232448;
// Chunk item: block rows hi at 0, lo at BIG; the other side's hi at 2 BIG,
// lo at 2 BIG + SMALL. Piece item: the transposed hi at 0 and lo at BIG
// (two 32-row blocks of SMALL bytes each), the raw rows at 2 BIG.


// A 64 x 64 accumulator of a warpgroup (this thread's 32 values: rows r0
// and r0 + 8, columns 8 n + 2 t and the next) sits in a P tile as the hi
// and lo tiles of a K-major operand over its columns (two 32-column
// blocks): the byte offset of row r0 + 8 e, columns 8 n + 2 t and + 1.
__device__ __forceinline__ uint32_t tile_off(int n, int e, int r0, int t) {
  const int r = r0 + 8 * e;
  return (n >> 2) * SMALL + r * ROW_BYTES + (((2 * (n & 3) + (t >> 1)) ^ (r & 7)) << 4) +
         8 * (t & 1);
}
__device__ __forceinline__ void put_tile(uint32_t tile, const float* x, int r0, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t off = tile_off(n, e, r0, t);
      uint32_t h0, l0, h1, l1;
      split(x[4 * n + 2 * e], h0, l0);
      split(x[4 * n + 2 * e + 1], h1, l1);
      sts64(tile + off, h0, h1);
      sts64(tile + BIG + off, l0, l1);
    }
  }
  fence_proxy_async();   // the tile is read by the warpgroup's next wgmmas
}
// Rewrites the values this thread put in a P tile as f(i, x), x their
// value (hi + lo, within 2^-22 of what was put) and i its accumulator slot.
template <typename F>
__device__ __forceinline__ void rewrite_tile(uint32_t tile, int r0, int t, F f) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t off = tile_off(n, e, r0, t);
      const float2 h = lds64(tile + off), l = lds64(tile + BIG + off);
      const int i = 4 * n + 2 * e;
      uint32_t h0, l0, h1, l1;
      split(f(i, h.x + l.x), h0, l0);
      split(f(i + 1, h.y + l.y), h1, l1);
      sts64(tile + off, h0, h1);
      sts64(tile + BIG + off, l0, l1);
    }
  }
  fence_proxy_async();
}


// d (64 x 64) (+)= A B over one k-step of 8, split: A_lo B_hi + A_hi B_lo +
// A_hi B_hi; A's rows from arow of its tiles, B's the first 64 of its.
__device__ __forceinline__ void mma3(float* d, uint32_t ah, uint32_t al, int arow, uint32_t bh,
                                     uint32_t bl, int st, int scale_d) {
  WgmmaTF32<64>::run(d, kmajor(al, arow, st), kmajor(bh, 0, st), scale_d);
  WgmmaTF32<64>::run(d, kmajor(ah, arow, st), kmajor(bl, 0, st), 1);
  WgmmaTF32<64>::run(d, kmajor(ah, arow, st), kmajor(bh, 0, st), 1);
}
// The products of an item go to a fresh accumulator d, which the running
// sums take by one rounded fp32 add (add_part): a wgmma's additions into its
// accumulator are not rounded to nearest, and their error grows with the
// instructions one accumulator takes.
// d = P tile (hi, lo at + BIG) . piece over the eight k-steps of 64 rows.
__device__ __forceinline__ void mma3_piece(float* d, uint32_t ptile, uint32_t piece) {
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    const uint32_t blk = (st >> 2) * SMALL;
    mma3(d, ptile + blk, ptile + BIG + blk, 0, piece + blk, piece + BIG + blk, st & 3, st > 0);
  }
}
// d = the warpgroup's 64 rows of the block's chunk tile (A) against the
// other side's 64 rows (B), over the chunk's first nks k-steps.
__device__ __forceinline__ void mma3_chunk(float* d, uint32_t st, int wg, int nks) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < nks)
      mma3(d, st, st + BIG, 64 * wg, st + 2 * BIG, st + 2 * BIG + SMALL, kk, kk > 0);
}
__device__ __forceinline__ void add_part(float* acc, float* part) {
  fence_all<32>(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}
__device__ __forceinline__ void zero32(float* acc) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}


// k-steps of 8 of chunk c that lie within D.
__device__ __forceinline__ int ksteps(int D, int c) { return min(4, (D - c * CHUNK) / 8); }
// Pieces of 64 columns of a slice of `width` from column c0 that lie within D.
__device__ __forceinline__ int pieces(int D, int c0, int width) {
  return min(width, D - c0 + PIECE - 1) / PIECE;
}

// ---- Forward.
constexpr int FWD_W = 256;   // output columns of a block (4 pieces)

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, int S, int H, int Hkv, int D, Strides qs,
                   Strides ks, Strides vs, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);

  const int nck = (D + CHUNK - 1) / CHUNK, nsl = (D + FWD_W - 1) / FWD_W;
  const int nqb = (S + ROWS - 1) / ROWS;
  // The query blocks, then the slices, of one head are neighbours in the
  // grid, so its K and V come from device memory once and from L2 after.
  const int qblk = blockIdx.x % nqb, sl = blockIdx.x / nqb % nsl, bh = blockIdx.x / nqb / nsl;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qblk * ROWS, c0 = sl * FWD_W, npc = pieces(D, c0, FWD_W);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qrow = q + b * qs.b + h * qs.h + (long long)q0 * qs.s;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int ntiles = (S + TILE_ROWS - 1) / TILE_ROWS, per = nck + npc;
  const uint32_t ptile = sbase + NST * ITEM + wg * PTILE;

  // Item r < nck of a key tile: chunk r of Q's rows and of the tile's K;
  // item nck + p: the tile's V piece p of the slice.
  auto load = [&](int i, uint32_t st) {
    const int r = i % per, k0 = i / per * TILE_ROWS;
    if (r < nck) {
      copy_chunk<ROWS>(st, qrow + r * CHUNK, qs.s, S - q0, D - r * CHUNK);
      copy_chunk<TILE_ROWS>(st + 2 * BIG, kb + k0 * ks.s + r * CHUNK, ks.s, S - k0,
                            D - r * CHUNK);
    } else {
      const int col = c0 + (r - nck) * PIECE;
      copy_piece(st + 2 * BIG, vb + k0 * vs.s + col, vs.s, S - k0, D - col);
    }
  };
  auto split_item = [&](int i, uint32_t st) {
    if (i % per < nck) {
      split_chunk<ROWS>(st, st + BIG);
      split_chunk<TILE_ROWS>(st + 2 * BIG, st + 2 * BIG + SMALL);
    } else {
      split_piece(st + 2 * BIG, st, st + BIG);
    }
  };
  auto rg = make_ring(sbase, ITEM, ntiles * per, load, split_item);
  rg.start();

  float o[FWD_W / 2];
#pragma unroll
  for (int i = 0; i < FWD_W / 2; ++i) o[i] = 0.f;
  // Running max in unscaled score units, per-thread partial denominators.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const int r0 = 16 * warp + g;   // this thread's rows of the warpgroup's 64: r0, r0 + 8
  float part[32];                 // an item's products

  for (int j = 0; j < ntiles; ++j) {
    const int kt = j * TILE_ROWS;
    float s[32];
    zero32(s);
    for (int c = 0; c < nck; ++c) {   // S = Q K^T over the D chunks
      rg.step([&](uint32_t st) { mma3_chunk(part, st, wg, ksteps(D, c)); },
              [&](uint32_t) {
                add_part(s, part);
                if (c < nck - 1) return;
                if (kt + TILE_ROWS > S) {   // the ragged last tile
#pragma unroll
                  for (int i = 0; i < 32; ++i)
                    if (kt + 8 * (i >> 2) + 2 * t + (i & 1) >= S) s[i] = -CUDART_INF_F;
                }
                float mx0 = m0, mx1 = m1;
#pragma unroll
                for (int n = 0; n < 8; ++n) {
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
                for (int n = 0; n < 8; ++n) {
                  s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -ms0));
                  s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -ms0));
                  s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -ms1));
                  s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -ms1));
                  sum0 += s[4 * n] + s[4 * n + 1];
                  sum1 += s[4 * n + 2] + s[4 * n + 3];
                }
                l0 = l0 * a0 + sum0;
                l1 = l1 * a1 + sum1;
#pragma unroll
                for (int n = 0; n < FWD_W / 8; ++n) {
                  o[4 * n] *= a0;
                  o[4 * n + 1] *= a0;
                  o[4 * n + 2] *= a1;
                  o[4 * n + 3] *= a1;
                }
                put_tile(ptile, s, r0, t);
              });
    }
#pragma unroll
    for (int p = 0; p < FWD_W / PIECE; ++p) {   // O += P V, piece by piece
      if (p >= npc) break;
      rg.step([&](uint32_t st) { mma3_piece(part, ptile, st); },
              [&](uint32_t) { add_part(o + 32 * p, part); });
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + 64 * wg + r0, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < FWD_W / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= D) continue;
    if (row0 < S)
      *reinterpret_cast<float2*>(out + (((long long)b * S + row0) * H + h) * D + c) =
          make_float2(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (row1 < S)
      *reinterpret_cast<float2*>(out + (((long long)b * S + row1) * H + h) * D + c) =
          make_float2(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
  if (lse != nullptr && sl == 0 && t == 0) {
    if (row0 < S) lse[(long long)bh * S + row0] = m0 * scale_log2 + log2f(l0);
    if (row1 < S) lse[(long long)bh * S + row1] = m1 * scale_log2 + log2f(l1);
  }
}

// ---- Backward.
// dQ, and delta for the dK/dV kernel.
constexpr int DQ_W = 256;    // dQ columns of a block (4 pieces)

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ o, const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dq, int S, int H, int Hkv,
                  int D, Strides qs, Strides ks, Strides vs, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);

  const int nck = (D + CHUNK - 1) / CHUNK, nsl = (D + DQ_W - 1) / DQ_W;
  const int nqb = (S + ROWS - 1) / ROWS;
  const int qblk = blockIdx.x % nqb, sl = blockIdx.x / nqb % nsl, bh = blockIdx.x / nqb / nsl;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qblk * ROWS, c0 = sl * DQ_W, npc = pieces(D, c0, DQ_W);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long drs = (long long)H * D;      // row stride of dout and o
  const float* qrow = q + b * qs.b + h * qs.h + (long long)q0 * qs.s;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const float* db = dout + ((long long)b * S * H + h) * D;
  const float* ob = o + ((long long)b * S * H + h) * D;
  const float* drow = db + q0 * drs;
  const int ntiles = (S + TILE_ROWS - 1) / TILE_ROWS, per = 2 * nck + npc;
  const uint32_t dtile = sbase + NST * ITEM + wg * PTILE;

  // Item c < nck of a key tile: chunk c of Q's rows and of the tile's K;
  // item nck + c: of dO's and V's; item 2 nck + p: the tile's K piece p.
  auto load = [&](int i, uint32_t st) {
    const int r = i % per, k0 = i / per * TILE_ROWS;
    if (r < 2 * nck) {
      const int col = r % nck * CHUNK;
      if (r >= nck) {
        copy_chunk<ROWS>(st, drow + col, drs, S - q0, D - col);
        copy_chunk<TILE_ROWS>(st + 2 * BIG, vb + k0 * vs.s + col, vs.s, S - k0, D - col);
      } else {
        copy_chunk<ROWS>(st, qrow + col, qs.s, S - q0, D - col);
        copy_chunk<TILE_ROWS>(st + 2 * BIG, kb + k0 * ks.s + col, ks.s, S - k0, D - col);
      }
    } else {
      const int col = c0 + (r - 2 * nck) * PIECE;
      copy_piece(st + 2 * BIG, kb + k0 * ks.s + col, ks.s, S - k0, D - col);
    }
  };
  auto split_item = [&](int i, uint32_t st) {
    if (i % per < 2 * nck) {
      split_chunk<ROWS>(st, st + BIG);
      split_chunk<TILE_ROWS>(st + 2 * BIG, st + 2 * BIG + SMALL);
    } else {
      split_piece(st + 2 * BIG, st, st + BIG);
    }
  };
  auto rg = make_ring(sbase, ITEM, ntiles * per, load, split_item);
  rg.start();

  // This thread's rows: their LSE, and delta = rowsum(dO O) from device
  // memory, the row's four threads taking every fourth 16-byte chunk.
  const int r0 = 16 * warp + g;
  const int row0 = q0 + 64 * wg + r0, row1 = row0 + 8;
  float dl[2], ls[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? row1 : row0;
    float acc = 0.f;
    if (r < S) {
      for (int c = t; c < D / 4; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(db + r * drs + 4 * c);
        const float4 e = *reinterpret_cast<const float4*>(ob + r * drs + 4 * c);
        acc += a.x * e.x + a.y * e.y + a.z * e.z + a.w * e.w;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[i] = acc;
    ls[i] = r < S ? lse[(long long)bh * S + r] : 0.f;
    if (sl == 0 && t == 0 && r < S) delta[(long long)bh * S + r] = acc;
  }

  float dqa[DQ_W / 2];
#pragma unroll
  for (int i = 0; i < DQ_W / 2; ++i) dqa[i] = 0.f;
  float part[32];

  for (int j = 0; j < ntiles; ++j) {
    const int kt = j * TILE_ROWS;
    float acc[32];   // S, then dP
    zero32(acc);
    for (int c = 0; c < nck; ++c) {   // S = Q K^T over the D chunks
      rg.step([&](uint32_t st) { mma3_chunk(part, st, wg, ksteps(D, c)); },
              [&](uint32_t) {
                add_part(acc, part);
                if (c < nck - 1) return;
                // p = exp2(s c - lse), zero for keys past S, to the tile.
#pragma unroll
                for (int i = 0; i < 32; ++i)
                  acc[i] = kt + 8 * (i >> 2) + 2 * t + (i & 1) < S
                               ? ex2(fmaf(acc[i], scale_log2, -ls[(i >> 1) & 1]))
                               : 0.f;
                put_tile(dtile, acc, r0, t);
              });
    }
    zero32(acc);
    for (int c = 0; c < nck; ++c) {   // dP = dO V^T over the D chunks
      rg.step([&](uint32_t st) { mma3_chunk(part, st, wg, ksteps(D, c)); },
              [&](uint32_t) {
                add_part(acc, part);
                if (c < nck - 1) return;
                // dS = p (dP - delta) over p in the tile.
                rewrite_tile(dtile, r0, t, [&](int i, float pv) {
                  return pv * (acc[i] - dl[(i >> 1) & 1]);
                });
              });
    }
#pragma unroll
    for (int p = 0; p < DQ_W / PIECE; ++p) {   // dQ += dS K, piece by piece
      if (p >= npc) break;
      rg.step([&](uint32_t st) { mma3_piece(part, dtile, st); },
              [&](uint32_t) { add_part(dqa + 32 * p, part); });
    }
  }

#pragma unroll
  for (int n = 0; n < DQ_W / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= D) continue;
    if (row0 < S)
      *reinterpret_cast<float2*>(dq + (((long long)b * S + row0) * H + h) * D + c) =
          make_float2(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
    if (row1 < S)
      *reinterpret_cast<float2*>(dq + (((long long)b * S + row1) * H + h) * D + c) =
          make_float2(dqa[4 * n + 2] * scale, dqa[4 * n + 3] * scale);
  }
}

// dK and dV; runs after flash_wide_dq_f32, which writes delta.
constexpr int DKV_W = 128;   // dK and dV columns of a block (2 pieces)

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Hkv,
                   int D, Strides qs, Strides ks, Strides vs, float scale_log2,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);

  const int nck = (D + CHUNK - 1) / CHUNK, nsl = (D + DKV_W - 1) / DKV_W;
  const int nkb = (S + ROWS - 1) / ROWS;
  const int kblk = blockIdx.x % nkb, sl = blockIdx.x / nkb % nsl, bkv = blockIdx.x / nkb / nsl;
  const int b = bkv / Hkv, hk = bkv % Hkv, group = H / Hkv;
  const int k0 = kblk * ROWS, c0 = sl * DKV_W, npc = pieces(D, c0, DKV_W);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long drs = (long long)H * D;
  const float* krow = k + b * ks.b + hk * ks.h + (long long)k0 * ks.s;
  const float* vrow = v + b * vs.b + hk * vs.h + (long long)k0 * vs.s;
  const int nqt = (S + TILE_ROWS - 1) / TILE_ROWS, ntiles = group * nqt;
  const int per = 2 * nck + 2 * npc;
  const uint32_t ptile = sbase + NST * (ITEM + TAIL) + wg * PTILE;

  // Tile jt: q-head hk * group + jt / nqt, queries (jt mod nqt) 64 on. Item
  // c < nck: chunk c of K's rows and of the tile's Q; items nck + p: the
  // tile's dO pieces p of the slice; items nck + npc + c: chunk c of V's rows
  // and of the tile's dO; items 2 nck + npc + p: the tile's Q pieces. The
  // last chunk of each of S^T and dP^T also brings the tile's LSE and delta
  // (zero past S).
  auto load = [&](int i, uint32_t st) {
    const int r = i % per, jt = i / per;
    const int h = hk * group + jt / nqt, qt0 = jt % nqt * TILE_ROWS;
    const float* qb = q + b * qs.b + h * qs.h + (long long)qt0 * qs.s;
    const float* dbp = dout + (((long long)b * S + qt0) * H + h) * D;
    const bool dp_item = r >= nck + npc && r < 2 * nck + npc;
    if (r < nck || dp_item) {
      const int col = (dp_item ? r - nck - npc : r) * CHUNK;
      if (dp_item) {
        copy_chunk<ROWS>(st, vrow + col, vs.s, S - k0, D - col);
        copy_chunk<TILE_ROWS>(st + 2 * BIG, dbp + col, drs, S - qt0, D - col);
      } else {
        copy_chunk<ROWS>(st, krow + col, ks.s, S - k0, D - col);
        copy_chunk<TILE_ROWS>(st + 2 * BIG, qb + col, qs.s, S - qt0, D - col);
      }
      if ((r == nck - 1 || r == 2 * nck + npc - 1) && threadIdx.x < 2 * TILE_ROWS) {
        const int i4 = threadIdx.x, c = i4 % TILE_ROWS;
        const bool ok = qt0 + c < S;
        const long long row = ((long long)b * H + h) * S;
        cp_async4(st + ITEM + 4 * i4, (i4 < TILE_ROWS ? lse : delta) + row + (ok ? qt0 + c : 0),
                  ok);
      }
    } else if (r < nck + npc) {
      const int col = c0 + (r - nck) * PIECE;
      copy_piece(st + 2 * BIG, dbp + col, drs, S - qt0, D - col);
    } else {
      const int col = c0 + (r - 2 * nck - npc) * PIECE;
      copy_piece(st + 2 * BIG, qb + col, qs.s, S - qt0, D - col);
    }
  };
  auto split_item = [&](int i, uint32_t st) {
    const int r = i % per;
    if (r < nck || (r >= nck + npc && r < 2 * nck + npc)) {
      split_chunk<ROWS>(st, st + BIG);
      split_chunk<TILE_ROWS>(st + 2 * BIG, st + 2 * BIG + SMALL);
    } else {
      split_piece(st + 2 * BIG, st, st + BIG);
    }
  };
  auto rg = make_ring(sbase, ITEM + TAIL, ntiles * per, load, split_item);
  rg.start();

  float dka[DKV_W / 2], dva[DKV_W / 2];
#pragma unroll
  for (int i = 0; i < DKV_W / 2; ++i) dka[i] = dva[i] = 0.f;
  const int r0 = 16 * warp + g;
  float part[32];

  // Queries past S are zero rows of Q and dO with LSE and delta zero: p = 1
  // and dS = 0 there, and p meets a zero row of dO, so they add nothing.
  // Column 8 n + 2 t + e of S^T is query 8 n + 2 t + e of the tile; its LSE
  // and delta sit in the tail of the last chunk's stage.
  for (int jt = 0; jt < ntiles; ++jt) {
    float acc[32];   // S^T, then dP^T
    zero32(acc);
    for (int c = 0; c < nck; ++c) {   // S^T = K Q^T over the D chunks
      rg.step([&](uint32_t st) { mma3_chunk(part, st, wg, ksteps(D, c)); },
              [&](uint32_t st) {
                add_part(acc, part);
                if (c < nck - 1) return;
#pragma unroll
                for (int i = 0; i < 32; ++i)
                  acc[i] = ex2(fmaf(acc[i], scale_log2,
                                    -lds32(st + ITEM + 4 * (8 * (i >> 2) + 2 * t + (i & 1)))));
                put_tile(ptile, acc, r0, t);   // P^T
              });
    }
#pragma unroll
    for (int p = 0; p < DKV_W / PIECE; ++p) {   // dV += P^T dO, piece by piece
      if (p >= npc) break;
      rg.step([&](uint32_t st) { mma3_piece(part, ptile, st); },
              [&](uint32_t) { add_part(dva + 32 * p, part); });
    }
    zero32(acc);
    for (int c = 0; c < nck; ++c) {   // dP^T = V dO^T over the D chunks
      rg.step([&](uint32_t st) { mma3_chunk(part, st, wg, ksteps(D, c)); },
              [&](uint32_t st) {
                add_part(acc, part);
                if (c < nck - 1) return;
                // dS^T = p (dP^T - delta) over P^T in the tile.
                rewrite_tile(ptile, r0, t, [&](int i, float pv) {
                  const int col = 8 * (i >> 2) + 2 * t + (i & 1);
                  return pv * (acc[i] - lds32(st + ITEM + 4 * (TILE_ROWS + col)));
                });
              });
    }
#pragma unroll
    for (int p = 0; p < DKV_W / PIECE; ++p) {   // dK += dS^T Q, piece by piece
      if (p >= npc) break;
      rg.step([&](uint32_t st) { mma3_piece(part, ptile, st); },
              [&](uint32_t) { add_part(dka + 32 * p, part); });
    }
  }

  const int row0 = k0 + 64 * wg + r0, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < DKV_W / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= D) continue;
    if (row0 < S) {
      const long long off = (((long long)b * S + row0) * Hkv + hk) * D + c;
      *reinterpret_cast<float2*>(dk + off) = make_float2(dka[4 * n] * scale, dka[4 * n + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dva[4 * n], dva[4 * n + 1]);
    }
    if (row1 < S) {
      const long long off = (((long long)b * S + row1) * Hkv + hk) * D + c;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }
}

constexpr int FWD_SMEM = NST * ITEM + 2 * PTILE + 1024;
constexpr int DQ_SMEM = FWD_SMEM;
constexpr int DKV_SMEM = NST * (ITEM + TAIL) + 2 * PTILE + 1024;
static_assert(DKV_SMEM <= SMEM_MAX, "the split-TF32 stages exceed shared memory");

// Blocks of a grid: rows / per blocks x slices x heads; 0 past the grid's limit.
unsigned grid_of(int S, int D, int width, long long heads) {
  const long long n = heads * ((D + width - 1) / width) * ((S + ROWS - 1) / ROWS);
  return n > 0x7fffffffLL ? 0u : (unsigned)n;
}

}  // namespace

// q, k, v: [B, S, H or Hkv, D] fp32 with the given element strides (D > 128
// a multiple of 8, contiguous, 16-byte aligned rows); out contiguous
// [B, S, H, D]; lse (optional) fp32 [B, H, S]. dtype must be 0 (fp32).
extern "C" int gaot_flash_wide_f32_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int S, int H, int Hkv, int D,
                                       long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh,
                                       float scale_log2, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || dtype != 0 || D <= MAX_D ||
      D % 8)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_of(S, D, FWD_W, (long long)B * H);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_fwd_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_wide_fwd_f32<<<blocks, THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), S, H, Hkv, D,
      Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, scale_log2);
  return (int)cudaGetLastError();
}

// dq, dk, dv contiguous ([B, S, H, D], [B, S, Hkv, D]); o and dout contiguous
// [B, S, H, D]; lse and the delta scratch fp32 [B, H, S]. Two launches.
extern "C" int gaot_flash_wide_f32_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B,
                                       int S, int H, int Hkv, int D, long long qsb,
                                       long long qss, long long qsh, long long ksb,
                                       long long kss, long long ksh, long long vsb,
                                       long long vss, long long vsh, float scale_log2,
                                       float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || dtype != 0 || D <= MAX_D ||
      D % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const unsigned bq = grid_of(S, D, DQ_W, (long long)B * H);
  const unsigned bkv = grid_of(S, D, DKV_W, (long long)B * Hkv);
  if (bq == 0 || bkv == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_dq_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_wide_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  flash_wide_dq_f32<<<bq, THREADS, DQ_SMEM, st>>>(qf, kf, vf, df, static_cast<const float*>(o),
                                                  l, dl, static_cast<float*>(dq), S, H, Hkv, D,
                                                  qs, ks, vs, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_wide_dkv_f32<<<bkv, THREADS, DKV_SMEM, st>>>(qf, kf, vf, df, l, dl,
                                                     static_cast<float*>(dk),
                                                     static_cast<float*>(dv), S, H, Hkv, D, qs,
                                                     ks, vs, scale_log2, scale);
  return (int)cudaGetLastError();
}

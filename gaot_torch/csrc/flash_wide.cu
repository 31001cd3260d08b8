// Grouped-query attention at head dims above 128 (any multiple of 8, D at
// run time), bf16, for Hopper (sm_90a): the forward (with and without the
// base-2 row LSE) and the backward (dQ, which also writes delta, then
// dK/dV), every product on wgmma. Replaces, for D > 128 in bf16, the TPU
// kernels of gaot_tpu/ops/pallas/flash_attention.py that the templated
// kernels of flash_attention.cu and flash_attention_bwd.cu replace for
// D <= 128: _attn_kernel and _attn_kernel_lse (_flash_forward), and the
// backward of all three regimes (_attn_bwd_kernel, _attn_bwd_tiled_kernel,
// _bwd_dq_kernel / _bwd_dkv_kernel). The arithmetic is the templated
// kernels': fp32 scores, running max and sum, exp2 with the base-2 LSE, P
// (and dS) rounded to bf16 before their products; the backward takes p from
// the saved LSE and applies the scale at the end of dQ and dK, as
// _flash_backward_long does. Deterministic: no float atomics.
//
// What bounds it: the products, 4 B H S^2 D operations forward and 10
// backward, on the tensor cores; at D > 128 the exp2 of each score is small
// beside them. A block cannot hold a head's outputs at large D in registers
// (64 rows x 256 fp32 columns take 128 registers a thread), so each block
// owns one slice of its outputs' head dim (a grid dimension) and recomputes
// the scores, and in the backward dP, over the full D for it:
//   forward  slices of 256 (one pass up to D = 256; 2.5x the function's
//            products at D = 1024),
//   dQ       slices of 256 (S, dP and dS of 64 keys beside a 64 x 256 dQ),
//   dK/dV    slices of 128 (dK and dV of 64 keys x 128 each, beside S^T and
//            dP^T of 64 queries).
// The design:
// - Two consumer warpgroups a block, 64 rows each of its resident side
//   (queries in the forward and dQ, keys in dK/dV); no producer warp: every
//   thread issues 16-byte cp.async copies.
// - Every operand sits in shared memory as "chunk tiles" of R rows x 64
//   columns (128 bytes a row) in wgmma's 128-byte swizzled layout, filled by
//   16-byte cp.async copies, eight threads to a row's 128 bytes, which the
//   swizzle spreads over the banks. A chunk tile serves K-major (K = head
//   dim) in the products over D (S = Q K^T, dP = dO V^T and their
//   transposes) and, through the
//   descriptor's transpose bit, MN-major (K = rows, N = 64 columns) in the
//   products whose N is the head dim (O += P V, dQ += dS K, dV += P^T dO,
//   dK += dS^T Q): nothing is transposed by hand. Columns past D and rows
//   past S are zero-filled, which pads the last k-step of 16 at D % 16 == 8
//   and a ragged last slice; the stores past D are masked.
// - The resident side stays in shared memory where it fits (queries of the
//   forward up to D = 512, queries and dO of dQ and keys and values of dK/dV
//   up to D = 256); above, it streams chunk by chunk with the other side.
// - The streamed operands pass through a ring of NST stages, each holding
//   one "item": a 64-column chunk of the other side for the products over D
//   (with the resident side's chunk where that streams), or a 64-column
//   piece of the output slice's operand. The copies of item i + NST - 1 are
//   issued right after the barrier that opens item i, so they run under its
//   products. Each item's wgmmas are waited for before the next barrier
//   (leaving one item's in flight measured no faster). The copies bound the
//   kernels on the H100: with the products taken out, the forward at D 256,
//   S 4096 kept two thirds of its time.
// - The forward: S (64 queries x 128 keys a warpgroup) accumulates over the
//   D chunks, then one online softmax (fp32 running max over the row's four
//   threads, one FFMA and one ex2.approx a score, only the ragged last key
//   tile masked), P rounded to bf16 and kept as the A fragments of P V, and
//   O += P V for the slice's four 64-column pieces of V. The epilogue
//   divides by the denominator and writes the LSE from slice 0 only.
// - dQ: delta = rowsum(dO O) of the block's rows in fp32 at the start (four
//   threads a row; slice 0 writes it for dK/dV), S and dP of 64 keys over D,
//   dS = p (dP - delta) with p = exp2(s c - lse), rounded to bf16, then
//   dQ += dS K for the slice's four 64-column pieces of K.
// - dK/dV: one block per (batch * kv-head, 128 keys, slice), looping over the
//   group's q-heads and every tile of 64 queries in a fixed order, so the
//   GQA group sum stays in fp32 registers. S^T and dP^T over D; the tile's
//   LSE and delta ride in the last D chunk's stage; P^T and dS^T rounded to
//   bf16 as register A fragments; dV += P^T dO and dK += dS^T Q for the
//   slice's two 64-column pieces of Q and dO.
// - Wave size: at B 1, H 4, S 4096 the forward has 128 blocks of 128 queries
//   a slice, under one wave of the H100's 132 SMs (one block an SM: the
//   ring and the resident queries take up to 224 KB); the kernel leaves the
//   four idle SMs idle.
// Plain C interface; each entry returns cudaGetLastError() after its
// launches.
#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int THREADS = 256;       // two warpgroups
constexpr int CHUNK = 64;          // columns of a chunk tile
constexpr int ROW_BYTES = 128;     // bytes of a chunk-tile row: one swizzle span
constexpr int ATOM = 8 * ROW_BYTES;   // bytes of a swizzle atom (8 rows)
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int chunk_bytes(int rows) { return rows * ROW_BYTES; }

// cp.async of an R x 64 chunk tile into dst: src is its first element (row
// stride rs), rows and cols the rows and columns the operand has from there
// (zero-filled past them). Copy i = threadIdx.x + 256 m moves the 16 bytes of
// row i / 8, column chunk i % 8: eight threads read a row's 128 bytes, and
// the swizzle spreads them over the banks. The copies bound these kernels,
// so their issue is kept to a few instructions a copy.
template <int R>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const bf16* src, long long rs,
                                           int rows, int cols) {
  const int rr = threadIdx.x >> 3, c = threadIdx.x & 7;
  const bf16* p = src + rr * rs + 8 * c;
  const uint32_t d = dst + rr * ROW_BYTES + ((c ^ (rr & 7)) << 4);
#pragma unroll
  for (int m = 0; m < R / 32; ++m) {
    const bool ok = rr + 32 * m < rows && 8 * c < cols;
    cp_async16(d + m * 32 * ROW_BYTES, ok ? p + 32 * m * rs : src, ok);
  }
}

// Chunk tiles sit in wgmma's 128-byte swizzled layout: row r at 128 r, its
// 16-byte column chunk c at ((c ^ r) mod 8) 16 within the row; a tile starts
// on a 1024-byte boundary.
// K-major piece: rows row0 .. (64 of A, or N of B), the 16 columns of k-step st.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int st) {
  return smem_desc(tile + row0 * ROW_BYTES + st * 32, 16, ATOM) | 1ull << 62;
}
// MN-major piece of a tile of R rows: rows (K) k0 .. k0 + 15, its 64 columns (N).
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int R, int k0) {
  return smem_desc(tile + k0 * ROW_BYTES, R * ROW_BYTES, ATOM) | 1ull << 62;
}

// acc (64 x 64, this thread's 32 values) += A . B for the four k-steps of a
// 64-row chunk tile read MN-major, A from registers.
__device__ __forceinline__ void mma_piece(float* acc, const uint32_t (*a)[4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<64, 1>::run(acc, a[kk], mnmajor(tile, 64, 16 * kk), 1);
}

// The ring: item `it` (item r of tile j, `per` items a tile) sits in stage
// it % NST; copies run NST - 1 items ahead. next() waits for the current
// item's copies, opens it with a barrier (every warpgroup is then done with
// the item before, whose stage the copies issued here overwrite) and returns
// its stage.
template <int NST, typename Load>
struct Ring {
  uint32_t base;
  int stage, per, nitems, it, lj, lr;   // lj, lr: tile and item of the next copy
  Load& load;
  __device__ __forceinline__ void issue(int idx) {
    load(lj, lr, base + (idx % NST) * stage);
    if (++lr == per) {
      lr = 0;
      ++lj;
    }
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {
      if (i < nitems) issue(i);
      cp_async_commit();   // the resident tiles join item 0's group
    }
  }
  __device__ __forceinline__ uint32_t next() {
    cp_async_wait<NST - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + NST - 1 < nitems) issue(it + NST - 1);
    cp_async_commit();
    return base + (it++ % NST) * stage;
  }
};
template <int NST, typename Load>
__device__ __forceinline__ Ring<NST, Load> make_ring(uint32_t base, int stage, int per,
                                                     int ntiles, Load& load) {
  return Ring<NST, Load>{base, stage, per, ntiles * per, 0, 0, 0, load};
}

// ---- Forward.
constexpr int FWD_ROWS = 128;        // queries of a block
constexpr int FWD_KEYS = 128;        // keys of a tile
constexpr int FWD_W = 256;           // output columns of a block (4 pieces)
constexpr int FWD_NST = 6;
constexpr int FWD_RES_CHUNKS = 8;    // queries resident up to D = 512

int fwd_smem(int nck) {
  const bool res = nck <= FWD_RES_CHUNKS;
  return (res ? nck * chunk_bytes(FWD_ROWS) : 0) +
         FWD_NST * (chunk_bytes(FWD_KEYS) + (res ? 0 : chunk_bytes(FWD_ROWS))) + 1024;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, int Hkv, int D, Strides qs,
                    Strides ks, Strides vs, float scale_log2) {
  constexpr int NS = FWD_KEYS / 2;              // S values a thread
  constexpr int KT = chunk_bytes(FWD_KEYS);     // bytes of a K or V chunk tile
  constexpr int QT = chunk_bytes(FWD_ROWS);     // bytes of a Q chunk tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);

  const int nck = (D + CHUNK - 1) / CHUNK, nsl = (D + FWD_W - 1) / FWD_W;
  const bool res = nck <= FWD_RES_CHUNKS;
  const int nqb = (S + FWD_ROWS - 1) / FWD_ROWS;
  // The query blocks, then the slices, of one head are neighbours in the
  // grid, so its K and V come from device memory once and from L2 after.
  const int qblk = blockIdx.x % nqb, sl = blockIdx.x / nqb % nsl, bh = blockIdx.x / nqb / nsl;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qblk * FWD_ROWS, c0 = sl * FWD_W;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int ntiles = (S + FWD_KEYS - 1) / FWD_KEYS;
  const int per = nck + FWD_W / CHUNK;          // items a key tile: D chunks, V pieces
  const uint32_t qres = sbase, ring = sbase + (res ? nck * QT : 0);

  // Item r < nck of a key tile: the tile's K chunk r (and Q's, where Q
  // streams); item nck + p: the tile's V piece p of the slice.
  const bf16* qrow = qb + (long long)q0 * qs.s;
  auto load = [&](int j, int r, uint32_t st) {
    const int k0 = j * FWD_KEYS;
    if (r < nck) {
      copy_chunk<FWD_KEYS>(st, kb + k0 * ks.s + r * CHUNK, ks.s, S - k0, D - r * CHUNK);
      if (!res) copy_chunk<FWD_ROWS>(st + KT, qrow + r * CHUNK, qs.s, S - q0, D - r * CHUNK);
    } else {
      const int col = c0 + (r - nck) * CHUNK;
      copy_chunk<FWD_KEYS>(st, vb + k0 * vs.s + col, vs.s, S - k0, D - col);
    }
  };
  if (res)
    for (int c = 0; c < nck; ++c)
      copy_chunk<FWD_ROWS>(qres + c * QT, qrow + c * CHUNK, qs.s, S - q0, D - c * CHUNK);
  auto rg = make_ring<FWD_NST>(ring, KT + (res ? 0 : QT), per, ntiles, load);
  rg.start();

  float o[FWD_W / 2];
#pragma unroll
  for (int i = 0; i < FWD_W / 2; ++i) o[i] = 0.f;
  // Running max in unscaled score units, per-thread partial denominators.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  uint32_t pa[FWD_KEYS / 16][4];   // P (bf16) as the A fragments of P V

  for (int j = 0; j < ntiles; ++j) {
    const int kt = j * FWD_KEYS;
    float s[NS];
    for (int c = 0; c < nck; ++c) {   // S = Q K^T over the D chunks
      const uint32_t st = rg.next();
      const uint32_t qt = res ? qres + c * QT : st + KT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<FWD_KEYS, 0, 0>::run(s, kmajor(qt, 64 * wg, kk), kmajor(st, 0, kk),
                                     c > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_all<NS>(s);
    }
    if (kt + FWD_KEYS > S) {   // the ragged last tile
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (kt + 8 * (i >> 2) + 2 * t + (i & 1) >= S) s[i] = -CUDART_INF_F;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < FWD_KEYS / 8; ++n) {
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
    for (int n = 0; n < FWD_KEYS / 8; ++n) {
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
    to_a_frags<FWD_KEYS>(pa, s);
#pragma unroll
    for (int p = 0; p < FWD_W / CHUNK; ++p) {   // O += P V, piece by piece
      const uint32_t st = rg.next();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_KEYS / 16; ++kk)
        Wgmma<64, 1>::run(o + 32 * p, pa[kk], mnmajor(st, FWD_KEYS, 16 * kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_all<32>(o + 32 * p);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < FWD_W / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + (((long long)b * S + r0) * H + h) * D + c) =
          pack_bf16(o[4 * n] / l0, o[4 * n + 1] / l0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + (((long long)b * S + r1) * H + h) * D + c) =
          pack_bf16(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
  if (lse != nullptr && sl == 0 && t == 0) {
    if (r0 < S) lse[(long long)bh * S + r0] = m0 * scale_log2 + log2f(l0);
    if (r1 < S) lse[(long long)bh * S + r1] = m1 * scale_log2 + log2f(l1);
  }
}

// ---- Backward.
constexpr int BWD_NST = 4;
constexpr int BWD_RES_CHUNKS = 4;    // the resident side stays up to D = 256

// dQ, and delta for the dK/dV kernel.
constexpr int DQ_ROWS = 128;         // queries of a block
constexpr int DQ_KEYS = 64;          // keys of a tile
constexpr int DQ_W = 256;            // dQ columns of a block (4 pieces)

__host__ __device__ int dq_stage(int nck) {
  return 2 * chunk_bytes(DQ_KEYS) + (nck <= BWD_RES_CHUNKS ? 0 : 2 * chunk_bytes(DQ_ROWS));
}
int dq_smem(int nck) {
  return (nck <= BWD_RES_CHUNKS ? 2 * nck * chunk_bytes(DQ_ROWS) : 0) + BWD_NST * dq_stage(nck) +
         1024;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const bf16* __restrict__ o, const float* __restrict__ lse,
                   float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int Hkv,
                   int D, Strides qs, Strides ks, Strides vs, float scale_log2, float scale) {
  constexpr int NS = DQ_KEYS / 2;
  constexpr int KT = chunk_bytes(DQ_KEYS), QT = chunk_bytes(DQ_ROWS);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);

  const int nck = (D + CHUNK - 1) / CHUNK, nsl = (D + DQ_W - 1) / DQ_W;
  const bool res = nck <= BWD_RES_CHUNKS;
  const int nqb = (S + DQ_ROWS - 1) / DQ_ROWS;
  const int qblk = blockIdx.x % nqb, sl = blockIdx.x / nqb % nsl, bh = blockIdx.x / nqb / nsl;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qblk * DQ_ROWS, c0 = sl * DQ_W;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long drs = (long long)H * D;      // row stride of dout and o
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const bf16* db = dout + ((long long)b * S * H + h) * D;
  const bf16* ob = o + ((long long)b * S * H + h) * D;
  const int ntiles = (S + DQ_KEYS - 1) / DQ_KEYS;
  const int per = nck + DQ_W / CHUNK;
  const uint32_t qres = sbase, dres = sbase + nck * QT;
  const uint32_t ring = sbase + (res ? 2 * nck * QT : 0);

  // Item r < nck of a key tile: its K and V chunks r (then Q's and dO's,
  // where they stream); item nck + p: its K piece p of the slice.
  const bf16* qrow = qb + (long long)q0 * qs.s;
  const bf16* drow = db + q0 * drs;
  auto load = [&](int j, int r, uint32_t st) {
    const int k0 = j * DQ_KEYS;
    if (r < nck) {
      const int col = r * CHUNK;
      copy_chunk<DQ_KEYS>(st, kb + k0 * ks.s + col, ks.s, S - k0, D - col);
      copy_chunk<DQ_KEYS>(st + KT, vb + k0 * vs.s + col, vs.s, S - k0, D - col);
      if (!res) {
        copy_chunk<DQ_ROWS>(st + 2 * KT, qrow + col, qs.s, S - q0, D - col);
        copy_chunk<DQ_ROWS>(st + 2 * KT + QT, drow + col, drs, S - q0, D - col);
      }
    } else {
      const int col = c0 + (r - nck) * CHUNK;
      copy_chunk<DQ_KEYS>(st, kb + k0 * ks.s + col, ks.s, S - k0, D - col);
    }
  };
  if (res) {
    for (int c = 0; c < nck; ++c) {
      copy_chunk<DQ_ROWS>(qres + c * QT, qrow + c * CHUNK, qs.s, S - q0, D - c * CHUNK);
      copy_chunk<DQ_ROWS>(dres + c * QT, drow + c * CHUNK, drs, S - q0, D - c * CHUNK);
    }
  }
  auto rg = make_ring<BWD_NST>(ring, dq_stage(nck), per, ntiles, load);
  rg.start();

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
    if (sl == 0 && t == 0 && r < S) delta[(long long)bh * S + r] = acc;
  }

  float dqa[DQ_W / 2];
#pragma unroll
  for (int i = 0; i < DQ_W / 2; ++i) dqa[i] = 0.f;
  uint32_t da[DQ_KEYS / 16][4];

  // Keys past S are zero rows of K and V: their dS is finite and meets a
  // zero row of K, so they add nothing to dQ.
  for (int j = 0; j < ntiles; ++j) {
    float s[NS], dp[NS];
    for (int c = 0; c < nck; ++c) {   // S = Q K^T and dP = dO V^T over the D chunks
      const uint32_t st = rg.next();
      const uint32_t qt = res ? qres + c * QT : st + 2 * KT;
      const uint32_t dt = res ? dres + c * QT : st + 2 * KT + QT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<DQ_KEYS, 0, 0>::run(s, kmajor(qt, 64 * wg, kk), kmajor(st, 0, kk),
                                    c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<DQ_KEYS, 0, 0>::run(dp, kmajor(dt, 64 * wg, kk), kmajor(st + KT, 0, kk),
                                    c > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_all<NS>(s);
      fence_all<NS>(dp);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = ex2(fmaf(s[i], scale_log2, -ls[(i >> 1) & 1]));
      dp[i] = p * (dp[i] - dl[(i >> 1) & 1]);
    }
    to_a_frags<DQ_KEYS>(da, dp);
#pragma unroll
    for (int p = 0; p < DQ_W / CHUNK; ++p) {   // dQ += dS K, piece by piece
      const uint32_t st = rg.next();
      wg_fence();
      mma_piece(dqa + 32 * p, da, st);
      wg_commit();
      wg_wait<0>();
      fence_all<32>(dqa + 32 * p);
    }
  }

#pragma unroll
  for (int n = 0; n < DQ_W / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * S + r0) * H + h) * D + c) =
          pack_bf16(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dq + (((long long)b * S + r1) * H + h) * D + c) =
          pack_bf16(dqa[4 * n + 2] * scale, dqa[4 * n + 3] * scale);
  }
}

// dK and dV; runs after flash_wide_dq_bf16, which writes delta.
constexpr int DKV_ROWS = 128;        // keys of a block
constexpr int DKV_QUERIES = 64;      // queries of a tile
constexpr int DKV_W = 128;           // dK and dV columns of a block (2 pieces)
constexpr int DKV_TAIL = 1024;       // a tile's LSE and delta (512 bytes), to the atom

__host__ __device__ int dkv_tail_at(int nck) {
  return 2 * chunk_bytes(DKV_QUERIES) + (nck <= BWD_RES_CHUNKS ? 0 : 2 * chunk_bytes(DKV_ROWS));
}
int dkv_smem(int nck) {
  return (nck <= BWD_RES_CHUNKS ? 2 * nck * chunk_bytes(DKV_ROWS) : 0) +
         BWD_NST * (dkv_tail_at(nck) + DKV_TAIL) + 1024;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_wide_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int Hkv,
                    int D, Strides qs, Strides ks, Strides vs, float scale_log2,
                    float scale) {
  constexpr int NS = DKV_QUERIES / 2;
  constexpr int QT = chunk_bytes(DKV_QUERIES), KT = chunk_bytes(DKV_ROWS);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);

  const int nck = (D + CHUNK - 1) / CHUNK, nsl = (D + DKV_W - 1) / DKV_W;
  const bool res = nck <= BWD_RES_CHUNKS;
  const int nkb = (S + DKV_ROWS - 1) / DKV_ROWS;
  const int kblk = blockIdx.x % nkb, sl = blockIdx.x / nkb % nsl, bkv = blockIdx.x / nkb / nsl;
  const int b = bkv / Hkv, hk = bkv % Hkv, group = H / Hkv;
  const int k0 = kblk * DKV_ROWS, c0 = sl * DKV_W;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long drs = (long long)H * D;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int nqt = (S + DKV_QUERIES - 1) / DKV_QUERIES, ntiles = group * nqt;
  const int per = nck + DKV_W / CHUNK;
  const int tail = dkv_tail_at(nck);
  const uint32_t kres = sbase, vres = sbase + nck * KT;
  const uint32_t ring = sbase + (res ? 2 * nck * KT : 0);

  // Tile jt: q-head hk * group + jt / nqt, queries (jt mod nqt) * 64 on.
  // Item r < nck: its Q and dO chunks r (then K's and V's, where they
  // stream; the last with the tile's LSE and delta, zero past S); item
  // nck + p: its Q and dO pieces p of the slice.
  const bf16* krow = kb + (long long)k0 * ks.s;
  const bf16* vrow = vb + (long long)k0 * vs.s;
  auto load = [&](int jt, int r, uint32_t st) {
    const int h = hk * group + jt / nqt, qt0 = jt % nqt * DKV_QUERIES;
    const bf16* qb = q + b * qs.b + h * qs.h + qt0 * qs.s;
    const bf16* db = dout + (((long long)b * S + qt0) * H + h) * D;
    const int col = r < nck ? r * CHUNK : c0 + (r - nck) * CHUNK;
    copy_chunk<DKV_QUERIES>(st, qb + col, qs.s, S - qt0, D - col);
    copy_chunk<DKV_QUERIES>(st + QT, db + col, drs, S - qt0, D - col);
    if (r < nck && !res) {
      copy_chunk<DKV_ROWS>(st + 2 * QT, krow + col, ks.s, S - k0, D - col);
      copy_chunk<DKV_ROWS>(st + 2 * QT + KT, vrow + col, vs.s, S - k0, D - col);
    }
    if (r == nck - 1 && threadIdx.x < 2 * DKV_QUERIES) {
      const int i = threadIdx.x, c = i % DKV_QUERIES;
      const bool ok = qt0 + c < S;
      const long long row = ((long long)b * H + h) * S;
      cp_async4(st + tail + 4 * i, (i < DKV_QUERIES ? lse : delta) + row + (ok ? qt0 + c : 0),
                ok);
    }
  };
  if (res) {
    for (int c = 0; c < nck; ++c) {
      copy_chunk<DKV_ROWS>(kres + c * KT, krow + c * CHUNK, ks.s, S - k0, D - c * CHUNK);
      copy_chunk<DKV_ROWS>(vres + c * KT, vrow + c * CHUNK, vs.s, S - k0, D - c * CHUNK);
    }
  }
  auto rg = make_ring<BWD_NST>(ring, tail + DKV_TAIL, per, ntiles, load);
  rg.start();

  float dka[DKV_W / 2], dva[DKV_W / 2];
#pragma unroll
  for (int i = 0; i < DKV_W / 2; ++i) dka[i] = dva[i] = 0.f;
  uint32_t pa[DKV_QUERIES / 16][4], sa[DKV_QUERIES / 16][4];

  // Queries past S are zero rows of Q and dO with LSE and delta zero: p = 1
  // and dS = 0 there, and p meets a zero row of dO, so they add nothing.
  for (int jt = 0; jt < ntiles; ++jt) {
    float s[NS], dp[NS];
    uint32_t st = 0;
    for (int c = 0; c < nck; ++c) {   // S^T = K Q^T and dP^T = V dO^T over the D chunks
      st = rg.next();
      const uint32_t kt = res ? kres + c * KT : st + 2 * QT;
      const uint32_t vt = res ? vres + c * KT : st + 2 * QT + KT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<DKV_QUERIES, 0, 0>::run(s, kmajor(kt, 64 * wg, kk), kmajor(st, 0, kk),
                                        c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<DKV_QUERIES, 0, 0>::run(dp, kmajor(vt, 64 * wg, kk), kmajor(st + QT, 0, kk),
                                        c > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_all<NS>(s);
      fence_all<NS>(dp);
    }
    // Column 8n + 2t + e of S^T is query 8n + 2t + e of the tile; its LSE
    // and delta sit in the last D chunk's stage, still open.
    const float* lq = reinterpret_cast<const float*>(
        smem + (st - static_cast<uint32_t>(__cvta_generic_to_shared(smem))) + tail) + 2 * t;
#pragma unroll
    for (int n = 0; n < DKV_QUERIES / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * n);
      const float2 d2 = *reinterpret_cast<const float2*>(lq + DKV_QUERIES + 8 * n);
      s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -l2.x));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -l2.y));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -l2.x));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -l2.y));
      dp[4 * n] = s[4 * n] * (dp[4 * n] - d2.x);
      dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - d2.y);
      dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - d2.x);
      dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - d2.y);
    }
    to_a_frags<DKV_QUERIES>(pa, s);
    to_a_frags<DKV_QUERIES>(sa, dp);
#pragma unroll
    for (int p = 0; p < DKV_W / CHUNK; ++p) {   // dV += P^T dO, dK += dS^T Q
      const uint32_t pt = rg.next();
      wg_fence();
      mma_piece(dva + 32 * p, pa, pt + QT);
      mma_piece(dka + 32 * p, sa, pt);
      wg_commit();
      wg_wait<0>();
      fence_all<32>(dva + 32 * p);
      fence_all<32>(dka + 32 * p);
    }
  }

  const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < DKV_W / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= D) continue;
    if (r0 < S) {
      const long long off = (((long long)b * S + r0) * Hkv + hk) * D + c;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dka[4 * n] * scale, dka[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[4 * n], dva[4 * n + 1]);
    }
    if (r1 < S) {
      const long long off = (((long long)b * S + r1) * Hkv + hk) * D + c;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
    }
  }
}

// Blocks of a grid: rows / per blocks x slices x heads; 0 past the grid's limit.
unsigned grid_of(int S, int rows, int D, int width, long long heads) {
  const long long n = heads * ((D + width - 1) / width) * ((S + rows - 1) / rows);
  return n > 0x7fffffffLL ? 0u : (unsigned)n;
}

}  // namespace

// q, k, v: [B, S, H or Hkv, D] bf16 with the given element strides (D > 128
// a multiple of 8, contiguous, 16-byte aligned rows); out contiguous
// [B, S, H, D]; lse (optional) fp32 [B, H, S]. dtype must be 1 (bf16).
extern "C" int gaot_flash_wide_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int S, int H, int Hkv, int D,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   float scale_log2, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || dtype != 1 || D <= MAX_D ||
      D % 8)
    return (int)cudaErrorInvalidValue;
  const int nck = (D + CHUNK - 1) / CHUNK, smem = fwd_smem(nck);
  const unsigned blocks = grid_of(S, FWD_ROWS, D, FWD_W, (long long)B * H);
  if (blocks == 0 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_fwd_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_wide_fwd_bf16<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, H, Hkv, D,
      Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, scale_log2);
  return (int)cudaGetLastError();
}

// dq, dk, dv contiguous ([B, S, H, D], [B, S, Hkv, D]); o and dout contiguous
// [B, S, H, D]; lse and the delta scratch fp32 [B, H, S]. Two launches.
extern "C" int gaot_flash_wide_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B, int S,
                                   int H, int Hkv, int D, long long qsb, long long qss,
                                   long long qsh, long long ksb, long long kss,
                                   long long ksh, long long vsb, long long vss,
                                   long long vsh, float scale_log2, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || dtype != 1 || D <= MAX_D ||
      D % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const int nck = (D + CHUNK - 1) / CHUNK;
  const int smem_q = dq_smem(nck), smem_kv = dkv_smem(nck);
  const unsigned bq = grid_of(S, DQ_ROWS, D, DQ_W, (long long)B * H);
  const unsigned bkv = grid_of(S, DKV_ROWS, D, DKV_W, (long long)B * Hkv);
  if (bq == 0 || bkv == 0 || smem_q > SMEM_MAX || smem_kv > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_dq_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_wide_dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  flash_wide_dq_bf16<<<bq, THREADS, smem_q, st>>>(qb, kb, vb, db, static_cast<const bf16*>(o),
                                                  l, dl, static_cast<bf16*>(dq), S, H, Hkv, D,
                                                  qs, ks, vs, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_wide_dkv_bf16<<<bkv, THREADS, smem_kv, st>>>(qb, kb, vb, db, l, dl,
                                                     static_cast<bf16*>(dk),
                                                     static_cast<bf16*>(dv), S, H, Hkv, D, qs,
                                                     ks, vs, scale_log2, scale);
  return (int)cudaGetLastError();
}

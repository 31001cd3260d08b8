// Split-TF32 staging shared by the fp32 kernels that run their products on
// the tensor cores (flash_wide_f32.cu, fused_ffn.cu): each fp32 operand x is
// held as hi = tf32(x) and lo = tf32(x - hi), and a product A B is taken as
// A_lo B_hi + A_hi B_lo + A_hi B_hi, three tf32 wgmmas (WgmmaTF32) whose
// operands both lie K-major in shared memory, in wgmma's 128-byte swizzled
// layout. Here: the split, the copies of a 32-column "chunk" of rows (K-major
// as it lies in device memory; each thread then splits the 16-byte pieces it
// copied, in place) and of a 64 x 64 "piece" (split and written transposed,
// for an operand that lies MN-major), the K-major descriptor, and the ring of
// stages that streams such items past the wgmmas.
#pragma once
#include "wgmma.cuh"

namespace tf32 {

using namespace hopper;

constexpr int ROW_BYTES = 128;           // a tile row: 32 fp32 columns
constexpr int ATOM = 8 * ROW_BYTES;      // bytes of a swizzle atom (8 rows)
constexpr int PIECE_BLOCK = 64 * ROW_BYTES;   // a 32-K-row block of a transposed piece

// tf32(x), cvt.rna.tf32.f32's rounding (to nearest, ties away from zero)
// in two integer operations: add half of the 13 dropped bits to the
// magnitude, then clear them. The same bits as the cvt, and faster on the
// card (the split runs once for every operand element an item stages).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to about 2^-22 of x. The hi tile must hold tf32(x): a tf32
// wgmma does not simply drop the 13 low bits of an fp32 operand (with raw
// x as hi the backward missed its bound).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float2 lds64(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float lds32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x[0]), "r"(x[1]),
               "r"(x[2]), "r"(x[3]) : "memory");
}
__device__ __forceinline__ void sts64(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(x), "r"(y) : "memory");
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(x) : "memory");
}

// A chunk tile of R rows: src is its first element (row stride rs), rows
// and cols what the operand has from there (zero-filled past them). Copy
// i = threadIdx.x + 256 m moves the 16 bytes of row i / 8, column chunk
// i % 8, to ((chunk ^ row) mod 8) 16 within the row.
template <int R>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const float* src, long long rs,
                                           int rows, int cols) {
  const int rr = threadIdx.x >> 3, c = threadIdx.x & 7;
  const float* p = src + rr * rs + 4 * c;
  const uint32_t d = dst + rr * ROW_BYTES + ((c ^ (rr & 7)) << 4);
#pragma unroll
  for (int m = 0; m < R / 32; ++m) {
    const bool ok = rr + 32 * m < rows && 4 * c < cols;
    cp_async16(d + m * 32 * ROW_BYTES, ok ? p + 32 * m * rs : src, ok);
  }
}
// The split of the pieces this thread copied into a chunk tile: hi in
// place, lo at the same place of the lo tile.
template <int R>
__device__ __forceinline__ void split_chunk(uint32_t hi, uint32_t lo) {
  const int rr = threadIdx.x >> 3, c = threadIdx.x & 7;
  const uint32_t off = rr * ROW_BYTES + ((c ^ (rr & 7)) << 4);
#pragma unroll
  for (int m = 0; m < R / 32; ++m) {
    const uint32_t a = off + m * 32 * ROW_BYTES;
    const float4 x = lds128(hi + a);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    sts128(hi + a, h);
    sts128(lo + a, l);
  }
}

// A piece: 64 rows x 64 columns, raw, row r's 16-byte chunk c at r 256 +
// ((c ^ r) mod 16) 16. Thread: warp w, lane l copies rows l / 2 + 16 a
// (a < 4), chunk 2 w + l % 2: two lanes read a row's 32 contiguous bytes.
__device__ __forceinline__ void copy_piece(uint32_t raw, const float* src, long long rs,
                                           int rows, int cols) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int c = 2 * w + (l & 1), r0 = l >> 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 16 * a;
    const bool ok = r < rows && 4 * c < cols;
    cp_async16(raw + r * 256 + (((c ^ r) & 15) << 4), ok ? src + r * rs + 4 * c : src, ok);
  }
}
// The split of this thread's pieces of a raw piece, written transposed:
// column n is row n of the hi and lo tiles, raw row r its K index r % 32 in
// block r / 32 (PIECE_BLOCK bytes a block), 4-byte element (r % 32) % 4 of 16-byte
// chunk (((r % 32) / 4) ^ n) mod 8. For one element of the four, a warp's
// 32 stores fall on 32 distinct banks.
__device__ __forceinline__ void split_piece(uint32_t raw, uint32_t hi, uint32_t lo) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int c = 2 * w + (l & 1), r0 = l >> 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 16 * a, kin = r & 31;
    const float4 x = lds128(raw + r * 256 + (((c ^ r) & 15) << 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * c + j;
      const uint32_t off = (r >> 5) * PIECE_BLOCK + n * ROW_BYTES +
                           ((((kin >> 2) ^ n) & 7) << 4) + ((kin & 3) << 2);
      uint32_t h, lw;
      split(xs[j], h, lw);
      sts32(hi + off, h);
      sts32(lo + off, lw);
    }
  }
}

// K-major operand in the 128-byte swizzled layout: rows row0 .. (64 of A or
// of B) of a chunk tile, the 8 columns of k-step st (32 bytes).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int st) {
  return smem_desc(tile + row0 * ROW_BYTES + st * 32, 16, ATOM) | 1ull << 62;
}

// The ring: item i sits in stage i % NST. start() issues the first NST
// items' copies and splits item 0; step() issues the current item's wgmmas
// (mma), splits the next item meanwhile, waits for the wgmmas, runs post
// (the stage still open), closes the item with a barrier (every warpgroup
// is then done with its stage) and issues the copies of item i + NST there.
template <typename Load, typename Split, int NST = 3>
struct Ring {
  uint32_t base;
  int stage, n, it;
  Load& load;
  Split& split_item;
  __device__ __forceinline__ uint32_t at(int i) const { return base + (i % NST) * stage; }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < NST; ++i) {
      if (i < n) load(i, at(i));
      cp_async_commit();
    }
    cp_async_wait<NST - 1>();
    split_item(0, at(0));
    fence_proxy_async();
    __syncthreads();
  }
  template <typename Mma, typename Post>
  __device__ __forceinline__ void step(Mma&& mma, Post&& post) {
    const uint32_t st = at(it);
    wg_fence();
    mma(st);
    wg_commit();
    if (it + 1 < n) {
      cp_async_wait<NST - 2>();
      split_item(it + 1, at(it + 1));
      fence_proxy_async();
    }
    wg_wait<0>();
    post(st);
    __syncthreads();
    if (it + NST < n) load(it + NST, st);
    cp_async_commit();
    ++it;
  }
};
template <int NST = 3, typename Load, typename Split>
__device__ __forceinline__ Ring<Load, Split, NST> make_ring(uint32_t base, int stage, int n,
                                                            Load& load, Split& split_item) {
  return Ring<Load, Split, NST>{base, stage, n, 0, load, split_item};
}

}  // namespace tf32

// The fp32 route of the flash-attention forward (flash_attention.cu,
// flash_fwd_f32) and backward (flash_attention_bwd.cu, flash_bwd_dq_f32 and
// flash_bwd_dkv_f32): the tile table by head dim and the register
// micro-tiles the three kernels share. Every product is full fp32 FFMA on
// the CUDA cores (no TF32), so what bounds them is the card's fp32 rate
// (67 TFLOP/s on the H100): 2 D FMAs a score forward, 5 D the backward's
// bound counts and 7 D its two deterministic kernels do (S and dP in both),
// so at most 5 / 7 = 71% of that bound.
//
// The layout of a block: NW warps, each owning RW rows of the block's
// resident side (queries in the forward and dQ, keys in dK/dV), staged
// once in shared memory. The other side streams through a ring of two
// shared-memory stages of BT rows, filled by 16-byte cp.async, the copy of
// tile t + 1 issued right after the barrier that opens tile t, so it lands
// under tile t's work. Every [rows, D] tile has rows of D + 4 floats:
// 16-byte loads of consecutive rows fall in distinct banks. Rows past S
// are zero-filled. Each warp's score tile stays in its registers as R x KC
// micro-tiles (F32Geom), built from 16-byte shared-memory loads over D, so
// each load feeds 4 KC or 4 R FMAs, not one; the softmax of a row runs over
// the LC lanes that hold it (xor shuffles); P (or dS) goes through a
// shared tile of the warp's own (__syncwarp, no block barrier) into the
// products whose N is D, again R x D / LC micro-tiles. A lane owns the same
// rows in both, so the rescale, the LSE and delta stay in registers. The
// loops over D and over a tile are unrolled whole: shared-memory offsets
// become immediates.
#pragma once
#include "flash_common.cuh"
#include "wgmma.cuh"

namespace flash {

// The geometry of a kernel's tiles: NW warps a block; in a warp, LR row
// lanes x LC = 32 / LR column lanes. Lane (r, c) = (l / LC, l % LC) owns
// rows r + LR i (i < R) of its warp's RW = LR R, the streamed rows
// c + LC k (k < KC) of a tile of BT = LC KC in the score products, and the
// output columns VW (c + LC m) .. + VW - 1 (m < NV) in the others. A
// product over D with an R x KC micro-tile reads (R + KC) / (R KC) floats
// from shared memory for each FMA. Tilings from 4 x 4 to 8 x 8 were tried
// at D = 32 on the H100 and ran close to one another, the table below
// taking the fastest: the shared memory's rate is not what binds them.
template <int D, int LR_, int R_, int KC_, int NW_>
struct F32Geom {
  static constexpr int LR = LR_, LC = 32 / LR_, R = R_, KC = KC_, NW = NW_;
  static constexpr int THREADS = 32 * NW;
  static constexpr int RW = LR * R;                   // rows a warp owns
  static constexpr int ROWS = NW * RW;                // resident rows a block
  static constexpr int BT = LC * KC;                  // streamed rows a tile
  static constexpr int LD = D + 4;                    // floats a [rows, D] tile row
  static constexpr int LP = BT + LC;                  // floats a row of a warp's P tile
  static constexpr int NO = D / LC;                   // output columns a lane
  static constexpr int VW = NO % 4 == 0 ? 4 : NO % 2 == 0 ? 2 : 1;
  static constexpr int NV = NO / VW;
  // Dynamic shared memory of each kernel with this geometry.
  static constexpr int FWD_SMEM = 4 * (ROWS * LD + 4 * BT * LD + NW * RW * LP);
  static constexpr int DQ_SMEM = 4 * (2 * ROWS * LD + 4 * BT * LD + NW * RW * LP);
  static constexpr int DKV_SMEM = 4 * (2 * ROWS * LD + 2 * (2 * BT * LD + 2 * BT) + NW * RW * LP);
  static_assert(D % 8 == 0 && D >= 8 && D <= MAX_D, "head dim must be a multiple of 8 from 8 to 128");
  static_assert(LR * LC == 32 && D % LC == 0 && BT % 4 == 0, "bad fp32 tile geometry");
};

// The tiles by head dim (at D <= 32 the fastest tried on the H100; above
// it smaller micro-tiles, as the output columns a lane owns, and with them
// the registers, grow with D):
//                  forward             dQ                  dK/dV
//   D              rows  R x KC  BT    rows  R x KC  BT    rows  R x KC  BT
//   8-32           128   8 x 8   32    128   8 x 4   16    128   8 x 4   32
//   40-64          64    4 x 8   64    64    4 x 8   64    64    4 x 4   32
//   72-128         64    4 x 4   32    64    4 x 4   32    64    4 x 4   32
template <int D>
struct F32Tile {
  static constexpr bool SMALL = D <= 32, MID = D <= 64;
  using Fwd = F32Geom<D, (SMALL ? 8 : 4), (SMALL ? 8 : 4), (MID ? 8 : 4), (SMALL ? 2 : 4)>;
  using Dq = F32Geom<D, (SMALL ? 8 : 4), (SMALL ? 8 : 4), (MID && !SMALL ? 8 : 4),
                     (SMALL ? 2 : 4)>;
  using Dkv = F32Geom<D, 4, (SMALL ? 8 : 4), 4, 4>;
  static_assert(Fwd::FWD_SMEM <= 232448 && Dq::DQ_SMEM <= 232448 && Dkv::DKV_SMEM <= 232448,
                "fp32 flash tiles exceed shared memory");
};

// cp.async of rows r0 .. r0 + R - 1 of a [*, D] fp32 operand (row stride rs)
// into a tile with rows of D + 4 floats; rows past S are zero-filled.
template <int D, int R>
__device__ __forceinline__ void f32_copy_rows(float* dst, const float* base, long long rs,
                                              int r0, int S) {
  constexpr int C = D / 4;
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < S;
    hopper::cp_async16(s + (r * (D + 4) + 4 * c) * 4,
                       ok ? base + (long long)(r0 + r) * rs + 4 * c : base, ok);
  }
}

// cp.async of n values from src into dst (4 bytes each); past S zero-filled.
__device__ __forceinline__ void f32_copy_vals(float* dst, const float* src, int r0, int n,
                                              int S) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ok = r0 + i < S;
    hopper::cp_async4(s + 4 * i, ok ? src + r0 + i : src, ok);
  }
}

template <int VW>
__device__ __forceinline__ void ld_vec(float (&x)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (VW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// acc[i][k] += A[LR i] . B[LC k] over D: A this lane's first resident row,
// B its first streamed row, both in tiles with rows of D + 4 floats; the
// sum runs over d in order, one FMA a term.
template <class G, int D>
__device__ __forceinline__ void f32_dots(float (&acc)[G::R][G::KC], const float* A,
                                         const float* B) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 a[G::R];
#pragma unroll
    for (int i = 0; i < G::R; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + G::LR * i * LD + d);
#pragma unroll
    for (int k = 0; k < G::KC; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(B + G::LC * k * LD + d);
#pragma unroll
      for (int i = 0; i < G::R; ++i) {
        acc[i][k] = fmaf(a[i].x, b.x, acc[i][k]);
        acc[i][k] = fmaf(a[i].y, b.y, acc[i][k]);
        acc[i][k] = fmaf(a[i].z, b.z, acc[i][k]);
        acc[i][k] = fmaf(a[i].w, b.w, acc[i][k]);
      }
    }
  }
}

// acc[i][.] += sum over the BT streamed rows t of P[LR i][t] T[t][cols]: P
// this lane's first row of its warp's P tile, T the streamed tile (rows of
// D + 4 floats), cols VW (c + LC m) .. + VW - 1.
template <class G, int D>
__device__ __forceinline__ void f32_accumulate(float (&acc)[G::R][G::NO], const float* P,
                                               const float* T, int c) {
  constexpr int LD = D + 4, VW = G::VW;
#pragma unroll
  for (int t = 0; t < G::BT; t += 4) {
    float4 p[G::R];
#pragma unroll
    for (int i = 0; i < G::R; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + G::LR * i * G::LP + t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = T + (t + e) * LD + VW * c;
#pragma unroll
      for (int m = 0; m < G::NV; ++m) {
        float x[VW];
        ld_vec<VW>(x, row + G::LC * VW * m);
#pragma unroll
        for (int i = 0; i < G::R; ++i) {
          const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int w = 0; w < VW; ++w) acc[i][m * VW + w] = fmaf(pe, x[w], acc[i][m * VW + w]);
        }
      }
    }
  }
}

// Stores v[i][k] at P[LR i][LC k] (this lane's first slot of its warp's P
// tile: row r, column c), after the warp is done reading the tile and
// before it reads it again.
template <class G>
__device__ __forceinline__ void f32_store_tile(float* P, const float (&v)[G::R][G::KC]) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < G::R; ++i)
#pragma unroll
    for (int k = 0; k < G::KC; ++k) P[G::LR * i * G::LP + G::LC * k] = v[i][k];
  __syncwarp();
}

// The sum and the max over the LC lanes of a row group.
template <int LC>
__device__ __forceinline__ float f32_row_sum(float x) {
#pragma unroll
  for (int off = 1; off < LC; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int LC>
__device__ __forceinline__ float f32_row_max(float x) {
#pragma unroll
  for (int off = 1; off < LC; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The output columns of lane c, vector m, of a [rows, D] tensor's row.
template <class G>
__device__ __forceinline__ int f32_col(int c, int m) {
  return G::VW * (c + G::LC * m);
}

}  // namespace flash

// Fused SwiGLU forward and backward for Hopper (sm_90a), bf16:
//   out = (silu(x W1^T) * (x W3^T)) W2^T,
// x [R, M], W1 and W3 [F, M], W2 [M, F] (torch Linear layouts), out [R, M].
// One block per 64-row tile of x, four warps of 16 rows. The x tile stays in
// shared memory while the block walks F in chunks of 32: h1 and h3 come from
// the tensor cores (mma.sync m16n8k16, fp32 accumulation), z = silu(h1) * h3
// is rounded to bf16 in registers (the accumulator layout of one product is
// the operand layout of the next) and out += z W2^T accumulates in fp32
// registers. h1, h3 and z never reach device memory. Rows past R are masked.
// The backward follows further below. Plain C interface; each entry returns
// cudaGetLastError() after its launches.
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

constexpr size_t kSmemMax = 232448;   // dynamic shared memory of one block

template <int M>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)BM * (M + PAD) + 2 * (size_t)FC * (M + PAD) +
                         (size_t)M * (FC + PAD));
}

// Above M = 256 the fp32 out accumulator of a warp (M / 2 values a thread)
// would pass the register file, so the block doubles to eight warps: warp w
// keeps rows 16 (w mod 4) and the output columns of half w / 4, and both
// halves recompute their rows' h1 and h3.
template <int M>
__host__ __device__ constexpr int fwd_halves() { return M > 256 ? 2 : 1; }

template <int M>
__global__ void __launch_bounds__(128 * fwd_halves<M>())
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
  const int wr = (warp & 3) * 16;     // warp's first row within the tile
  constexpr int NN = M / 8 / fwd_halves<M>();   // output n-tiles of a warp
  const int n0 = (warp >> 2) * NN;    // its first output n-tile
  static_assert(smem_bytes<M>() <= kSmemMax, "SwiGLU forward tiles exceed shared memory");

  for (int i = threadIdx.x; i < BM * (M / 8); i += blockDim.x) {
    const int r = i / (M / 8), ch = (i % (M / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < R)
      val = *reinterpret_cast<const uint4*>(x + (long long)(row0 + r) * M + ch);
    *reinterpret_cast<uint4*>(Xs + r * XS + ch) = val;
  }

  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
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
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int st = 0; st < FC / 16; ++st) {
        const bf16* bp = W2s + (8 * (n0 + n) + g) * WS + st * 16 + 2 * t;
        mma_bf16_16816(acc[n], za[st], ld32(bp), ld32(bp + 8));
      }
    }
  }

  const int r0 = row0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int c = 8 * (n0 + n) + 2 * t;
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
  ffn_fwd_kernel<M><<<(R + BM - 1) / BM, 128 * fwd_halves<M>(), smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), R, F);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward (the TPU kernel's math; h1, h3 and z are recomputed, never stored):
//   dz  = dout W2            (dout [R, M], W2 [M, F])
//   dh1 = dz * h3 * silu'(h1),   dh3 = dz * silu(h1)        (rounded to bf16)
//   dx  = dh1 W1 + dh3 W3                                   (bf16 out)
//   dW1 = dh1^T x,  dW3 = dh3^T x,  dW2 = dout^T z           (fp32)
// The TPU kernel carries dW across its sequential grid; blocks on the card run
// in no order, so the work is split in three deterministic launches:
//   ffn_bwd_dx:     one block per 64-row tile walks F in chunks of 32;
//   ffn_bwd_dw:     one block per (F chunk, row split) sums its rows' dW
//                   chunk in fp32 registers and writes it to a partial;
//   ffn_bwd_reduce: sums the row-split partials in a fixed order.
// Eight warps per block. Every tile sits in shared memory once, in its natural
// row-major layout, copied with 16-byte cp.async while the previous tile is
// being computed (double buffers); a product that needs it transposed loads
// its fragments with ldmatrix.trans.
// The row tile and the buffering follow M (BwdTiles): up to M = 256 tiles of
// 64 rows, double buffered; above it 32 rows, and a single buffer where two
// would pass the 227 KB a block may hold (M = 512). With 32-row tiles the
// eight warps are 2 row groups x 4 column groups instead of 4 x 2.

constexpr int BW = 256;  // threads of the backward blocks

template <int M>
struct BwdTiles {
  static constexpr int BM = M <= 256 ? 64 : 32;   // rows of a tile
  static constexpr int RG = BM / 16;              // warps along the rows
  static constexpr int NQ = 8 / RG;               // warps along F or M
  static constexpr int FQ = FC / NQ;              // F columns of a warp (phase A)
  static constexpr int NJ = FQ / 8;               // their n-tiles
  static constexpr int XS = M + PAD, TS = FC + PAD;
  static constexpr size_t WCH = 2 * (size_t)FC * XS + (size_t)M * TS;  // one W chunk
  __host__ __device__ static constexpr size_t dx_bytes(int st) {
    return sizeof(bf16) * (2 * (size_t)BM * XS + st * WCH + 2 * (size_t)BM * TS);
  }
  __host__ __device__ static constexpr size_t dw_bytes(int st) {
    return sizeof(bf16) * (WCH + st * 2 * (size_t)BM * XS + 3 * (size_t)BM * TS);
  }
  static constexpr int DX_ST = dx_bytes(2) <= kSmemMax ? 2 : 1;   // W chunk buffers
  static constexpr int DW_ST = dw_bytes(2) <= kSmemMax ? 2 : 1;   // x/dout buffers
  static_assert(dx_bytes(DX_ST) <= kSmemMax && dw_bytes(DW_ST) <= kSmemMax,
                "SwiGLU backward tiles exceed shared memory");
  static_assert(M % (16 * NQ) == 0 && M % 128 == 0, "unsupported SwiGLU width");
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// 16-byte asynchronous copy global -> shared; valid == false writes zeros.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// ldmatrix .x4 .trans: four 8x8 bf16 tiles of a row-major shared array, each
// delivered transposed into one register of the mma fragment layout. Lanes
// 8i .. 8i+7 give the row addresses of tile i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// B operands (k x n) of the n-tiles n0 and n0 + 8 at k-step k0, from a
// row-major [k][n] shared array of row stride LD: b[0], b[1] for n0 and
// b[2], b[3] for n0 + 8.
template <int LD>
__device__ __forceinline__ void ldsm_b_pair(uint32_t b[4], const bf16* S,
                                            int k0, int n0, int lane) {
  ldsm_x4_t(b, S + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

// A operand (16 x 16) of the rows m0 .. m0 + 15 at k-step k0, from a
// row-major [k][m] shared array of row stride LD (the operand's transpose).
template <int LD>
__device__ __forceinline__ void ldsm_a_t(uint32_t a[4], const bf16* S, int k0,
                                         int m0, int lane) {
  ldsm_x4_t(a, S + (k0 + (lane & 7) + (lane >> 4) * 8) * LD + m0 +
                   ((lane >> 3) & 1) * 8);
}

// The shared copy of one F chunk: rows f0 .. f0+FC-1 of W1 and W3 ([F, M])
// as W1s/W3s ([f][m]) and the columns f0 .. f0+FC-1 of W2 ([M, F]) as W2c
// ([m][f]).
template <int M>
struct WChunk {
  static constexpr int XS = M + PAD, TS = FC + PAD;
  static constexpr int ELEMS = 2 * FC * XS + M * TS;
  bf16* W1s;
  bf16* W3s;
  bf16* W2c;
  __device__ explicit WChunk(bf16* base)
      : W1s(base), W3s(base + FC * XS), W2c(base + 2 * FC * XS) {}
};

// Starts the copy of chunk f0 into w (cp.async, not yet committed).
template <int M>
__device__ __forceinline__ void load_w_chunk_async(
    const bf16* __restrict__ w1, const bf16* __restrict__ w3,
    const bf16* __restrict__ w2, int F, int f0, const WChunk<M>& w) {
  constexpr int XS = WChunk<M>::XS, TS = WChunk<M>::TS;
  for (int i = threadIdx.x; i < FC * (M / 8); i += blockDim.x) {
    const int r = i / (M / 8), ch = (i % (M / 8)) * 8;
    const long long src = (long long)(f0 + r) * M + ch;
    cp_async16(w.W1s + r * XS + ch, w1 + src, true);
    cp_async16(w.W3s + r * XS + ch, w3 + src, true);
  }
  for (int i = threadIdx.x; i < M * (FC / 8); i += blockDim.x) {
    const int m = i / (FC / 8), ch = (i % (FC / 8)) * 8;
    cp_async16(w.W2c + m * TS + ch, w2 + (long long)m * F + f0 + ch, true);
  }
}

// Starts the copy of a BwdTiles<M>::BM-row tile of a [R, M] bf16 matrix into
// T ([r][m]); rows past R become zeros.
template <int M>
__device__ __forceinline__ void load_rows_async(const bf16* __restrict__ src,
                                                int R, int row0, bf16* T) {
  constexpr int XS = M + PAD;
  for (int i = threadIdx.x; i < BwdTiles<M>::BM * (M / 8); i += blockDim.x) {
    const int r = i / (M / 8), ch = (i % (M / 8)) * 8;
    const bool valid = row0 + r < R;
    cp_async16(T + r * XS + ch, src + (long long)(valid ? row0 + r : 0) * M + ch,
               valid);
  }
}

// h1, h3 and dz of one warp: rows wr .. wr+15 of the tile, F-chunk columns
// fh .. fh+8NJ-1 (NJ n-tiles of 8).
template <int M, int NJ = BwdTiles<M>::NJ>
__device__ __forceinline__ void chunk_products(
    const bf16* Xs, const bf16* Ds, const WChunk<M>& w, int wr, int fh,
    int lane, float (*h1)[4], float (*h3)[4], float (*dz)[4]) {
  constexpr int XS = M + PAD, TS = FC + PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) h1[j][e] = h3[j][e] = dz[j][e] = 0.f;
#pragma unroll 4
  for (int st = 0; st < M / 16; ++st) {
    const bf16* xa = Xs + (wr + g) * XS + st * 16 + 2 * t;
    const uint32_t a[4] = {ld32(xa), ld32(xa + 8 * XS), ld32(xa + 8),
                           ld32(xa + 8 * XS + 8)};
    const bf16* da = Ds + (wr + g) * XS + st * 16 + 2 * t;
    const uint32_t d[4] = {ld32(da), ld32(da + 8 * XS), ld32(da + 8),
                           ld32(da + 8 * XS + 8)};
    uint32_t b2[4];   // at NJ = 1 the second n-tile (pad columns) goes unused
    ldsm_b_pair<TS>(b2, w.W2c, st * 16, fh, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = (fh + 8 * j + g) * XS + st * 16 + 2 * t;
      mma_bf16_16816(h1[j], a, ld32(w.W1s + n), ld32(w.W1s + n + 8));
      mma_bf16_16816(h3[j], a, ld32(w.W3s + n), ld32(w.W3s + n + 8));
      mma_bf16_16816(dz[j], d, b2[2 * j], b2[2 * j + 1]);
    }
  }
}

template <int M>
__global__ void __launch_bounds__(BW)
ffn_bwd_dx(const bf16* __restrict__ x, const bf16* __restrict__ dout,
           const bf16* __restrict__ w1, const bf16* __restrict__ w3,
           const bf16* __restrict__ w2, bf16* __restrict__ dx, int R, int F) {
  using Tl = BwdTiles<M>;
  constexpr int BR = Tl::BM, ST = Tl::DX_ST, NJ = Tl::NJ;
  constexpr int MW = M / Tl::NQ;           // dx columns of a warp (phase B)
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = M + PAD, TS = FC + PAD;
  bf16* Xs = reinterpret_cast<bf16*>(smem);           // [BR][XS]
  bf16* Ds = Xs + BR * XS;                            // [BR][XS]  dout
  bf16* Wb = Ds + BR * XS;                            // [ST][WChunk]
  bf16* H1 = Wb + ST * WChunk<M>::ELEMS;              // [BR][TS]  dh1
  bf16* H3 = H1 + BR * TS;                            // [BR][TS]  dh3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BR;
  const int wr = (warp % Tl::RG) * 16;     // the warp's 16 rows
  const int fh = (warp / Tl::RG) * Tl::FQ; // its F-chunk columns (phase A)
  const int mh = (warp / Tl::RG) * MW;     // its dx columns (phase B)

  load_rows_async<M>(x, R, row0, Xs);
  load_rows_async<M>(dout, R, row0, Ds);
  load_w_chunk_async<M>(w1, w3, w2, F, 0, WChunk<M>(Wb));
  cp_async_commit();

  float acc[MW / 8][4];
#pragma unroll
  for (int n = 0; n < MW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int f0 = 0, it = 0; f0 < F; f0 += FC, ++it) {
    const WChunk<M> w(Wb + (it % ST) * WChunk<M>::ELEMS);
    __syncthreads();   // every warp is done with the buffer to refill and H1/H3
    if (ST == 2) {
      if (f0 + FC < F)
        load_w_chunk_async<M>(w1, w3, w2, F, f0 + FC,
                              WChunk<M>(Wb + ((it + 1) % ST) * WChunk<M>::ELEMS));
      cp_async_commit();
      cp_async_wait_prev();
    } else {
      if (f0 > 0) load_w_chunk_async<M>(w1, w3, w2, F, f0, w);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    float h1[NJ][4], h3[NJ][4], dz[NJ][4];
    chunk_products<M>(Xs, Ds, w, wr, fh, lane, h1, h3, dz);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float d1[2], d3[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * half + u;
          const float sg = sigmoid(h1[j][e]);
          d1[u] = dz[j][e] * h3[j][e] * (sg * (1.f + h1[j][e] * (1.f - sg)));
          d3[u] = dz[j][e] * h1[j][e] * sg;
        }
        const int o = (wr + g + 8 * half) * TS + fh + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(H1 + o) = pack_bf16(d1[0], d1[1]);
        *reinterpret_cast<uint32_t*>(H3 + o) = pack_bf16(d3[0], d3[1]);
      }
    }
    __syncthreads();
    // dx[wr.., mh..] += dh1 W1c + dh3 W3c over the chunk's 32 values of f;
    // W1c and W3c are the B operands [f][m], read transposed.
#pragma unroll
    for (int st = 0; st < FC / 16; ++st) {
      const bf16* p1 = H1 + (wr + g) * TS + st * 16 + 2 * t;
      const bf16* p3 = H3 + (wr + g) * TS + st * 16 + 2 * t;
      const uint32_t a1[4] = {ld32(p1), ld32(p1 + 8 * TS), ld32(p1 + 8),
                              ld32(p1 + 8 * TS + 8)};
      const uint32_t a3[4] = {ld32(p3), ld32(p3 + 8 * TS), ld32(p3 + 8),
                              ld32(p3 + 8 * TS + 8)};
#pragma unroll
      for (int p = 0; p < MW / 16; ++p) {
        uint32_t b1[4], b3[4];
        ldsm_b_pair<XS>(b1, w.W1s, st * 16, mh + 16 * p, lane);
        ldsm_b_pair<XS>(b3, w.W3s, st * 16, mh + 16 * p, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16_16816(acc[2 * p + j], a1, b1[2 * j], b1[2 * j + 1]);
          mma_bf16_16816(acc[2 * p + j], a3, b3[2 * j], b3[2 * j + 1]);
        }
      }
    }
  }

  const int r0 = row0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < MW / 8; ++n) {
    const int c = mh + 8 * n + 2 * t;
    if (r0 < R)
      *reinterpret_cast<__nv_bfloat162*>(dx + (long long)r0 * M + c) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r1 < R)
      *reinterpret_cast<__nv_bfloat162*>(dx + (long long)r1 * M + c) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// part: [splits][3][F * M] fp32 — dW1 [F, M], dW3 [F, M], dW2 [M, F].
template <int M>
__global__ void __launch_bounds__(BW)
ffn_bwd_dw(const bf16* __restrict__ x, const bf16* __restrict__ dout,
           const bf16* __restrict__ w1, const bf16* __restrict__ w3,
           const bf16* __restrict__ w2, float* __restrict__ part, int R, int F,
           int tiles_per_split) {
  using Tl = BwdTiles<M>;
  constexpr int BR = Tl::BM, ST = Tl::DW_ST, NJ = Tl::NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = M + PAD, TS = FC + PAD;
  const WChunk<M> w(reinterpret_cast<bf16*>(smem));
  bf16* XD = w.W1s + WChunk<M>::ELEMS;      // [ST][x, dout][BR][XS]
  bf16* H1 = XD + ST * 2 * BR * XS;                   // [BR][TS]  dh1
  bf16* H3 = H1 + BR * TS;                            // [BR][TS]  dh3
  bf16* Z = H3 + BR * TS;                             // [BR][TS]  z

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.x * FC;
  const int wr = (warp % Tl::RG) * 16, fh = (warp / Tl::RG) * Tl::FQ;  // phase A
  const int ft = (warp & 1) * 16;                          // dW1/dW3 f rows
  const int mb = (warp >> 1) * (M / 4);                    // dW1/dW3 m cols
  const int mw = warp * (M / 8);                           // dW2 m rows

  float a1[M / 32][4], a3[M / 32][4], a2[M / 128][4][4];
#pragma unroll
  for (int n = 0; n < M / 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[n][e] = a3[n][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < M / 128; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) a2[mt][n][e] = 0.f;

  const int ntiles = (R + BR - 1) / BR;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(ntiles, tile0 + tiles_per_split);
  load_w_chunk_async<M>(w1, w3, w2, F, f0, w);
  if (tile0 < tile1) {
    load_rows_async<M>(x, R, tile0 * BR, XD);
    load_rows_async<M>(dout, R, tile0 * BR, XD + BR * XS);
  }
  cp_async_commit();
  for (int tile = tile0, it = 0; tile < tile1; ++tile, ++it) {
    bf16* Xs = XD + 2 * (it % ST) * BR * XS;
    bf16* Ds = Xs + BR * XS;
    __syncthreads();   // every warp is done with the buffer to refill and H1/H3/Z
    if (ST == 2) {
      if (tile + 1 < tile1) {
        bf16* nx = XD + 2 * ((it + 1) % ST) * BR * XS;
        load_rows_async<M>(x, R, (tile + 1) * BR, nx);
        load_rows_async<M>(dout, R, (tile + 1) * BR, nx + BR * XS);
      }
      cp_async_commit();
      cp_async_wait_prev();
    } else {
      if (tile > tile0) {
        load_rows_async<M>(x, R, tile * BR, Xs);
        load_rows_async<M>(dout, R, tile * BR, Ds);
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    float h1[NJ][4], h3[NJ][4], dz[NJ][4];
    chunk_products<M>(Xs, Ds, w, wr, fh, lane, h1, h3, dz);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float d1[2], d3[2], z[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * half + u;
          const float sg = sigmoid(h1[j][e]);
          d1[u] = dz[j][e] * h3[j][e] * (sg * (1.f + h1[j][e] * (1.f - sg)));
          d3[u] = dz[j][e] * h1[j][e] * sg;
          z[u] = h1[j][e] * sg * h3[j][e];
        }
        const int o = (wr + g + 8 * half) * TS + fh + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(H1 + o) = pack_bf16(d1[0], d1[1]);
        *reinterpret_cast<uint32_t*>(H3 + o) = pack_bf16(d3[0], d3[1]);
        *reinterpret_cast<uint32_t*>(Z + o) = pack_bf16(z[0], z[1]);
      }
    }
    __syncthreads();
    // Reduce over the tile's BR rows (k = r, k-steps of 16): the A operands
    // dh1^T, dh3^T and dout^T and the B operands x and z are all read
    // transposed from their [r][*] tiles.
#pragma unroll
    for (int st = 0; st < BR / 16; ++st) {
      uint32_t x1[4], x3[4];
      ldsm_a_t<TS>(x1, H1, st * 16, ft, lane);
      ldsm_a_t<TS>(x3, H3, st * 16, ft, lane);
#pragma unroll
      for (int p = 0; p < M / 64; ++p) {
        uint32_t bx[4];
        ldsm_b_pair<XS>(bx, Xs, st * 16, mb + 16 * p, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16_16816(a1[2 * p + j], x1, bx[2 * j], bx[2 * j + 1]);
          mma_bf16_16816(a3[2 * p + j], x3, bx[2 * j], bx[2 * j + 1]);
        }
      }
      uint32_t bz[2][4];
      ldsm_b_pair<TS>(bz[0], Z, st * 16, 0, lane);
      ldsm_b_pair<TS>(bz[1], Z, st * 16, 16, lane);
#pragma unroll
      for (int mt = 0; mt < M / 128; ++mt) {
        uint32_t ad[4];
        ldsm_a_t<XS>(ad, Ds, st * 16, mw + 16 * mt, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16_16816(a2[mt][n], ad, bz[n >> 1][2 * (n & 1)],
                         bz[n >> 1][2 * (n & 1) + 1]);
      }
    }
  }
  cp_async_wait_all();   // a split with no rows still has the W chunk in flight

  const long long fm = (long long)F * M;
  float* p1 = part + (long long)blockIdx.y * 3 * fm;
  float* p3 = p1 + fm;
  float* p2 = p3 + fm;
#pragma unroll
  for (int n = 0; n < M / 32; ++n) {
    const int m = mb + 8 * n + 2 * t;
    const long long o0 = (long long)(f0 + ft + g) * M + m, o1 = o0 + 8LL * M;
    *reinterpret_cast<float2*>(p1 + o0) = make_float2(a1[n][0], a1[n][1]);
    *reinterpret_cast<float2*>(p1 + o1) = make_float2(a1[n][2], a1[n][3]);
    *reinterpret_cast<float2*>(p3 + o0) = make_float2(a3[n][0], a3[n][1]);
    *reinterpret_cast<float2*>(p3 + o1) = make_float2(a3[n][2], a3[n][3]);
  }
#pragma unroll
  for (int mt = 0; mt < M / 128; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int m = mw + 16 * mt + g;
      const long long o0 = (long long)m * F + f0 + 8 * n + 2 * t;
      const long long o1 = o0 + 8LL * F;
      *reinterpret_cast<float2*>(p2 + o0) = make_float2(a2[mt][n][0], a2[mt][n][1]);
      *reinterpret_cast<float2*>(p2 + o1) = make_float2(a2[mt][n][2], a2[mt][n][3]);
    }
}

__global__ void ffn_bwd_reduce(const float* __restrict__ part,
                               float* __restrict__ out, long long n,
                               int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

template <int M>
cudaError_t launch_bwd(const void* x, const void* w1, const void* w3,
                       const void* w2, const void* dout, void* dx, void* part,
                       void* dw, int R, int F, int splits,
                       cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(dout);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w3b = static_cast<const bf16*>(w3);
  const bf16* w2b = static_cast<const bf16*>(w2);
  using Tl = BwdTiles<M>;
  constexpr size_t smem_dx = Tl::dx_bytes(Tl::DX_ST);
  constexpr size_t smem_dw = Tl::dw_bytes(Tl::DW_ST);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_dx<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dx);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ffn_bwd_dw<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dw);
  if (err != cudaSuccess) return err;
  const int ntiles = (R + Tl::BM - 1) / Tl::BM;
  const int tps = (ntiles + splits - 1) / splits;
  ffn_bwd_dx<M><<<ntiles, BW, smem_dx, stream>>>(xb, db, w1b, w3b, w2b,
                                                 static_cast<bf16*>(dx), R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_bwd_dw<M><<<dim3(F / FC, splits), BW, smem_dw, stream>>>(
      xb, db, w1b, w3b, w2b, static_cast<float*>(part), R, F, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 3LL * F * M;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ffn_bwd_reduce<<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                             static_cast<float*>(dw), n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gaot_fused_ffn_fwd(const void* x, const void* w1, const void* w3,
                                  const void* w2, void* out, int R, int M,
                                  int F, void* stream) {
  if (R <= 0 || F <= 0 || F % FC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Built for every width the JAX gate takes up to 512 (M % 128 == 0).
  switch (M) {
    case 128: return (int)launch<128>(x, w1, w3, w2, out, R, F, s);
    case 256: return (int)launch<256>(x, w1, w3, w2, out, R, F, s);
    case 384: return (int)launch<384>(x, w1, w3, w2, out, R, F, s);
    case 512: return (int)launch<512>(x, w1, w3, w2, out, R, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows of the backward's tiles at width M (0 for a width it is not built
// for): the caller splits the rows of the dW kernel by these tiles.
extern "C" int gaot_fused_ffn_bwd_row_tile(int M) {
  switch (M) {
    case 128: return BwdTiles<128>::BM;
    case 256: return BwdTiles<256>::BM;
    case 384: return BwdTiles<384>::BM;
    case 512: return BwdTiles<512>::BM;
    default: return 0;
  }
}

// dx [R, M] bf16; part: [splits][3 F M] fp32 scratch; dw: [3 F M] fp32 out
// (dW1 [F, M], dW3 [F, M], dW2 [M, F] back to back).
extern "C" int gaot_fused_ffn_bwd(const void* x, const void* w1, const void* w3,
                                  const void* w2, const void* dout, void* dx,
                                  void* part, void* dw, int R, int M, int F,
                                  int splits, void* stream) {
  if (R <= 0 || F <= 0 || F % FC || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 128: return (int)launch_bwd<128>(x, w1, w3, w2, dout, dx, part, dw, R, F, splits, s);
    case 256: return (int)launch_bwd<256>(x, w1, w3, w2, dout, dx, part, dw, R, F, splits, s);
    case 384: return (int)launch_bwd<384>(x, w1, w3, w2, dout, dx, part, dw, R, F, splits, s);
    case 512: return (int)launch_bwd<512>(x, w1, w3, w2, dout, dx, part, dw, R, F, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

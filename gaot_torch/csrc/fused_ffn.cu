// Fused SwiGLU forward and backward for Hopper (sm_90a):
//   out = (silu(x W1^T) * (x W3^T)) W2^T,
// x [R, M], W1 and W3 [F, M], W2 [M, F] (torch Linear layouts), out [R, M].
// Replaces the TPU kernels _fwd_kernel (_ffn_call) and _bwd_kernel
// (_ffn_bwd_call) of gaot_tpu/ops/pallas/fused_ffn.py. What bounds them on
// the card: the tensor cores (6 R M F operations forward, 16 R M F backward);
// at the fx shape x, out and the weights move in a fifth of the forward
// products' time.
//
// Every bf16 product runs on wgmma with both operands, or B, read from
// shared memory through descriptors, in wgmma's swizzled layouts (the
// no-swizzle layout ran the same products far slower). Tiles
// stream through rings of shared-memory stages, so the next tile's copy
// overlaps this tile's products. Each operand is read as it lies in device
// memory, K-major or MN-major (the descriptor's transpose bit), so no
// product needs a transposed copy.
//
// bf16 forward at M = 128, 256 (ffn_fwd_fused): a block owns 128 rows of x,
// resident in shared memory, and two warpgroups of 64 rows; it walks F in
// chunks of FC (64 at M = 128, 32 at 256) through a three-stage ring of the
// chunk's W1 and W3 rows (the K-major B of h = x W^T as torch lays them out)
// and W2 columns (the K-major B of out += z W2^T). h1 and h3 come as one
// product of N = 2 FC; z = silu(h1) h3 is formed in registers in the A
// fragment layout of the second product, which takes it from registers; the
// 64 x M fp32 output stays in registers (M / 2 a thread). The previous
// chunk's second product runs on the tensor cores while this chunk's h is
// issued. h1, h3 and z never leave the chip. The weights are first packed
// (ffn_pack_w) into the stages' layout, chunk after chunk, so that one
// thread fills a stage with one bulk copy, counted on an mbarrier: filling
// it by 16-byte cp.async from every thread took far longer.
//
// bf16 backward at M = 128, 256 (ffn_bwd_rows, then ffn_gemm): the same
// rows and ring, with dout resident beside x. Per chunk a warpgroup computes
// h1 | h3 and dz = dout W2c (the W2 tile read MN-major), forms dh1, dh3 and z
// in registers and accumulates dx += [dh1 dh3] [W1c; W3c] with the W1|W3
// tile read MN-major: dx stays in registers. It stores dh1 | dh3 and z
// ([R, 2F] and [R, F], bf16, 16 bytes a lane) for the weight gradients
// while the next chunk's h and dz products run. Then one GEMM launch
// computes dW1|dW3 = [dh1 dh3]^T x and dW2 = dout^T z, the reduction over
// the rows split across blocks into fp32 partials that a last pass sums in a
// fixed order (no float atomics). Every product is computed once: 16 R M F
// operations against the 22 of recomputing h1, h3 and dz in two kernels; the
// price is the intermediates' round trip through device memory (3 x 134 MB
// written and read back at the fx shape).
//
// Every other width the JAX gate takes (M % 128 == 0, F % 128 == 0), where a
// warpgroup's 64 x M fp32 output or the resident x and dout pass the chip,
// goes through one warp-specialized, persistent kernel skeleton (ffn_ws: a
// TMA producer warpgroup and an mbarrier ring feeding two wgmma warpgroups;
// see its section) in three modes:
//   forward (2 launches): the producer (h1 | h3 over 128 x 128 tiles of
//     [R, F], z to a bf16 scratch), then the GEMM out = z W2^T;
//   backward (3 launches): the producer (h1 | h3 and dz over 128 x 128 tiles,
//     dh1 | dh3 and z to the scratches), then one GEMM launch for the weight
//     gradients' row-split partials and dx = [dh1 dh3] [W1; W3], then their
//     fixed-order sum.
//
// fp32 (every width): the same products on the tensor cores as split TF32
// (tf32_split.cuh): each operand x as hi = tf32(x) and lo = tf32(x - hi),
// each product as A_lo B_hi + A_hi B_lo + A_hi B_hi, three tf32 wgmmas with
// fp32 accumulators, which keeps fp32's accuracy (TF32 stays off) at
// 3 x 16 R M F operations on a 495 TFLOP/s unit instead of 16 R M F at the
// CUDA cores' 67. A tf32 wgmma reads both operands K-major, so the kernels
// take every operand K-major: a producer (ffn_tf32_produce: h1 | h3 over a
// 128-row x 64-column tile of F, and dz, the SwiGLU in fp32 in its
// epilogue) and a GEMM with runtime shapes (ffn_tf32_gemm: 128 x 128 tiles,
// up to three products a launch), both streaming 32-column chunks of their
// operands through a three-stage cp.async ring, split in shared memory by
// the threads that copied them, each chunk's products in a fresh
// accumulator added to the running sums in fp32:
//   forward (2 launches): z to an fp32 scratch, then out = z W2^T;
//   backward (4 launches): W2^T, [W1; W3]^T, x^T and dout^T transposed in
//     device memory (ffn_tf32_transpose; 2 R M + 3 F M floats); dh1 | dh3
//     to [R, 2F] and, transposed, with z to [2F, R] and [F, R]; then dx and
//     the weight gradients' row-split partials in one GEMM launch; then
//     their fixed-order sum (deterministic, no float atomics).
//
// bf16: silu(h) = h / (1 + 2^(-h log2 e)) by ex2.approx and rcp.approx
// (relative error about 2^-21 against the plain version's exact sigmoid, far
// below the bf16 rounding of z); fp32: 1 / (1 + expf(-h)). Plain C
// interface; each entry returns cudaGetLastError() after its launches.
#include <climits>

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

#include "tf32_split.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kSmemMax = 232448;   // dynamic shared memory of one block

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoid_fast(float x) {
  return rcp_approx(1.f + ex2(-1.4426950408889634f * x));
}

// dh1 = dz h3 silu'(h1), dh3 = dz silu(h1), z = silu(h1) h3 (fp32).
__device__ __forceinline__ void swiglu_grads(float h1, float h3, float dz,
                                             float& dh1, float& dh3, float& z) {
  const float sg = sigmoid_fast(h1);
  dh1 = dz * h3 * (sg * (1.f + h1 * (1.f - sg)));
  dh3 = dz * h1 * sg;
  z = h1 * sg * h3;
}

// ---- shared-memory tiles in wgmma's swizzled layouts. A K-major tile keeps
// each row's RB bytes of K (RB = 128, 64 or 32) together, rows RB bytes
// apart, and stores the 16-byte chunk c of row r at chunk
// c ^ ((r RB / 128) mod RB / 16): the rows that a wgmma reads at one K
// position fall on distinct banks (the no-swizzle layout puts them on the
// same ones, which ran the products far slower). An atom of 8
// rows is 8 RB bytes and sits on an 8 RB-byte boundary. A tile wider than
// 64 along K is a row of such tiles, 64 of K each. Read MN-major (N or M
// contiguous), the same bytes are atoms of 8 K-rows x 64 columns.

template <int RB>
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return r * RB + ((c ^ ((r * RB >> 7) & (RB / 16 - 1))) << 4);
}

// Descriptor of a K-major piece starting at addr (its first row, plus 32
// bytes per k-step of 16 into the row).
// The same descriptor serves an MN-major read of a tile of RB-byte rows
// along its rows (N = RB / 2 columns, one atom wide, K-rows RB bytes apart).
template <int RB>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr) {
  constexpr uint64_t type = RB == 128 ? 1 : RB == 64 ? 2 : 3;   // 128, 64, 32-byte swizzle
  return smem_desc(addr, 16, 8 * RB) | type << 62;
}

// Descriptor of an MN-major piece of 16 K-rows from K-row k0 (a multiple of
// 8) and columns from mn0 (a multiple of 64) of a tile whose 64-column
// blocks lie `block` bytes apart (128-byte rows).
__device__ __forceinline__ uint64_t desc_mn_sw(uint32_t base, int k0, int mn0, int block) {
  return smem_desc(base + (mn0 / 64) * block + k0 * 128, block, 1024) | 1ull << 62;
}

// An MN-major slice of 64 K-rows x NN (MN contiguous) into dst, as NN / 64
// blocks of 64 columns, 64 x 128 bytes each: K-row k from p + k * ld,
// columns mn0 on; K-rows at or past klim are zero-filled.
template <int NN>
__device__ __forceinline__ void copy_mnmajor(uint32_t dst, const bf16* p,
                                             long long ld, int klim, int mn0) {
  constexpr int C = NN / 8;
  for (int i = threadIdx.x; i < 64 * C; i += blockDim.x) {
    const int k = i / C, c = i % C;
    const bool ok = k < klim;
    cp_async16(dst + (c >> 3) * 8192 + sw_off<128>(k, c & 7),
               ok ? p + (long long)k * ld + mn0 + 8 * c : p, ok);
  }
}

// Descriptor of k-step st of a 64 x 16 A piece or a 16 x N B piece whose
// first row or column is mn0 (a multiple of 64), in a slice copied as above.
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int mn0, int st) {
  return desc_mn_sw(base, 16 * st, mn0, 8192);
}

// Waits until this thread's cp.async groups but the newest N have landed,
// makes them visible to wgmma, then a block barrier: every thread's have.
template <int N>
__device__ __forceinline__ void ring_landed() {
  cp_async_wait<N>();
  fence_proxy_async();
  __syncthreads();
}

// The K-slice pipeline of the weight-gradient GEMM: NST stages,
// NST - 2 slices in flight, one barrier per slice. load(kt, stage) issues the
// cp.async copies of slice kt; mma(stage) issues its wgmmas. Slice kt - 1's
// wgmmas stay in flight while slice kt's are issued; the copy into a stage
// starts only after every warpgroup has waited for the wgmmas that read it.
template <int NST, class Load, class Mma>
__device__ __forceinline__ void k_pipeline(int nk, uint32_t sbase, int stage_bytes,
                                           Load load, Mma mma) {
  constexpr int P = NST - 2;
  static_assert(P >= 1, "the ring needs at least three stages");
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nk) load(i, sbase + i * stage_bytes);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ring_landed<P - 1>();
    if (kt + P < nk) load(kt + P, sbase + ((kt + P) % NST) * stage_bytes);
    cp_async_commit();
    wg_fence();
    mma(sbase + (kt % NST) * stage_bytes);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
}

// ---- the weight-gradient GEMM of the fused route: C[i, j] = sum_k A[i, k]
// B[k, j] over one 128 x BN tile of C, K from k_begin to k_end (a multiple of
// 64 apart, but for the last split), both operands MN-major (A[k * lda + i],
// B[k * ldb + j]); C the fp32 partial of split blockIdx.z (rows past `rows`
// dropped).
constexpr int GT = 128;                   // C tile rows
constexpr int GNST = 4;                   // stages of the ring
template <int BN>                         // C tile columns
struct GemmTile {
  static constexpr int A = GT * 64 * 2;   // bytes of A's slice in a stage
  static constexpr int STAGE = A + BN * 64 * 2, SMEM = GNST * STAGE + 1024;
  static_assert(SMEM <= kSmemMax, "GEMM stages exceed shared memory");
};

struct GemmArgs {
  const bf16* a;
  long long lda;
  const bf16* b;
  long long ldb;
  void* c;
  long long ldc, split_stride;
  int rows, cols, k, k_per_split;
};

// One launch may run two products of the same kind (the weight gradients):
// blocks below tiles0 (along x) take g0's tiles, the others g1's.
template <int BN>
__global__ void __launch_bounds__(256) ffn_gemm(GemmArgs g0, GemmArgs g1, int tiles0) {
  using Tl = GemmTile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);
  const bool first = (int)blockIdx.x < tiles0;
  const GemmArgs g = first ? g0 : g1;
  const int tile = first ? blockIdx.x : blockIdx.x - tiles0;
  const int i0 = tile / (g.cols / BN) * GT, j0 = tile % (g.cols / BN) * BN;
  const int kb = blockIdx.z * g.k_per_split;
  const int ke = min(g.k, kb + g.k_per_split);
  const int nk = ke > kb ? (ke - kb + 63) / 64 : 0;
  const int wg = threadIdx.x >> 7;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  auto load = [&](int kt, uint32_t st) {
    const int k0 = kb + kt * 64;
    copy_mnmajor<GT>(st, g.a + (long long)k0 * g.lda, g.lda, ke - k0, i0);
    copy_mnmajor<BN>(st + Tl::A, g.b + (long long)k0 * g.ldb, g.ldb, ke - k0, j0);
  };
  auto mma = [&](uint32_t st) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      WgmmaSS<BN, 1, 1>::run(acc, desc_mn(st, 64 * wg, s), desc_mn(st + Tl::A, 0, s), 1);
  };
  k_pipeline<GNST>(nk, sbase, Tl::STAGE, load, mma);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = i0 + 64 * wg + 16 * warp + (lane >> 2), r1 = r0 + 8;
  float* c = static_cast<float*>(g.c) + blockIdx.z * g.split_stride;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = j0 + 8 * n + 2 * (lane & 3);
    if (r0 < g.rows)
      *reinterpret_cast<float2*>(c + (long long)r0 * g.ldc + col) =
          make_float2(acc[4 * n], acc[4 * n + 1]);
    if (r1 < g.rows)
      *reinterpret_cast<float2*>(c + (long long)r1 * g.ldc + col) =
          make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---- the fused bf16 kernels at M = 128, 256 (see the top of the file): a
// block of 128 rows (two warpgroups of 64) with its rows of x (and dout)
// resident, walking F in chunks of FC through a ring of NST stages. A stage
// holds the chunk's W1 rows, then its W3 rows (M / 64 blocks of 2 FC rows x
// 128 bytes: one K-major B of N = 2 FC for h1 | h3), then W2's columns
// (M rows of RB bytes).
template <int M_, int FC_, int NST_>
struct ChunkTiles {
  static constexpr int M = M_, FC = FC_, NST = NST_;
  static constexpr int BR = 128;                     // rows: two warpgroups of 64
  static constexpr int NH = 2 * FC;                  // h1 | h3 columns of a chunk
  static constexpr int RB = FC * 2;                  // bytes of a W2 row (its K)
  static constexpr int XBYTES = BR * M * 2;          // one resident [BR, M] tile
  static constexpr int W13 = 2 * FC * M * 2, STAGE = W13 + M * FC * 2;
  static_assert(NST >= 2 && (FC == 32 || FC == 64) && M % 64 == 0 && M <= 256, "bad tiling");
};

// Chunk c of the weights as a ring stage holds it: put(off, src) moves the
// 16 bytes at src to byte off of the stage. All threads of the block take
// part.
template <class T, class Put>
__device__ __forceinline__ void w_chunk(const bf16* w1, const bf16* w3, const bf16* w2,
                                        int F, int c, Put put) {
  constexpr int M = T::M, FC = T::FC;
  const int f0 = c * FC;
  for (int i = threadIdx.x; i < 2 * FC * (M / 8); i += blockDim.x) {
    const int n = i / (M / 8), ch = i % (M / 8);
    const bf16* w = n < FC ? w1 + (long long)(f0 + n) * M : w3 + (long long)(f0 + n - FC) * M;
    put((ch >> 3) * (2 * FC * 128) + sw_off<128>(n, ch & 7), w + 8 * ch);
  }
  for (int i = threadIdx.x; i < M * (FC / 8); i += blockDim.x) {
    const int m = i / (FC / 8), ch = i % (FC / 8);
    put(T::W13 + sw_off<T::RB>(m, ch), w2 + (long long)m * F + f0 + 8 * ch);
  }
}

// The weight chunks in their ring-stage layout, chunk blockIdx.x at
// packed + blockIdx.x STAGE bytes, so that one bulk copy fills a stage.
template <class T>
__global__ void __launch_bounds__(256)
ffn_pack_w(const bf16* __restrict__ w1, const bf16* __restrict__ w3,
           const bf16* __restrict__ w2, unsigned char* __restrict__ packed, int F) {
  unsigned char* st = packed + (long long)blockIdx.x * T::STAGE;
  w_chunk<T>(w1, w3, w2, F, blockIdx.x, [&](int off, const bf16* src) {
    *reinterpret_cast<uint4*>(st + off) = *reinterpret_cast<const uint4*>(src);
  });
}

// mbarriers and the copy engine's bulk copies.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of a phase that completes once `bytes` more have landed.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// bytes (a multiple of 16) from src to dst, counted on bar as they land.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The ring of weight chunks: NST stages from ring on, chunk c in stage
// c % NST, filled by thread 0 with one bulk copy of its packed image and
// signalled on that stage's mbarrier (its k-th fill completes phase k).
template <class T>
struct BulkRing {
  uint32_t ring, bar0;
  const unsigned char* packed;

  __device__ uint32_t stage(int c) const { return ring + (c % T::NST) * T::STAGE; }
  __device__ void fill(int c) const {
    const uint32_t bar = bar0 + 8 * (c % T::NST);
    mbar_expect_tx(bar, T::STAGE);
    bulk_copy(stage(c), packed + (long long)c * T::STAGE, T::STAGE, bar);
  }
  // Thread 0: the barriers, then the first `first` chunks.
  __device__ void start(int first) const {
    for (int s = 0; s < T::NST; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_mbar_init();
    for (int c = 0; c < first; ++c) fill(c);
  }
  __device__ void wait(int c) const { mbar_wait(bar0 + 8 * (c % T::NST), (c / T::NST) & 1); }
};

// The block's BR rows of a [R, M] tensor into dst (M / 64 blocks of BR rows
// x 128 bytes), rows at or past R zero-filled.
template <class T>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* a, int row0, int R) {
  constexpr int M = T::M;
  for (int i = threadIdx.x; i < T::BR * (M / 8); i += blockDim.x) {
    const int r = i / (M / 8), ch = i % (M / 8);
    const bool ok = row0 + r < R;
    cp_async16(dst + (ch >> 3) * (T::BR * 128) + sw_off<128>(r, ch & 7),
               a + (long long)(ok ? row0 + r : 0) * M + 8 * ch, ok);
  }
}

template <class T>
__device__ __forceinline__ void store_rows(bf16* out, const float* o, int r0, int R, int t) {
#pragma unroll
  for (int n = 0; n < T::M / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < R)
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * T::M + col) = pack_bf16(o[4 * n], o[4 * n + 1]);
    if (r0 + 8 < R)
      *reinterpret_cast<uint32_t*>(out + (long long)(r0 + 8) * T::M + col) =
          pack_bf16(o[4 * n + 2], o[4 * n + 3]);
  }
}

// The fused forward: a ring of NST >= 3 stages, NST - 2 chunks in flight.
template <int M_, int FC_, int NST_>
struct FusedFwd : ChunkTiles<M_, FC_, NST_> {
  using B = ChunkTiles<M_, FC_, NST_>;
  static constexpr int SMEM = B::XBYTES + NST_ * B::STAGE + 1024;
  static_assert(SMEM <= kSmemMax, "SwiGLU forward tiles exceed shared memory");
  static_assert(NST_ >= 3, "the forward's ring needs three stages");
};

// out[64 x M] += z . W2c^T for k-step kk, in pieces of N = 128 (or 64).
template <class T, int C0 = 0>
__device__ __forceinline__ void out_pieces(float* o, const uint32_t a[4], uint32_t w2c, int kk) {
  if constexpr (C0 < T::M) {
    constexpr int N = T::M - C0 >= 128 ? 128 : 64;
    Wgmma<N, 0>::run(o + C0 / 2, a, desc_sw<T::RB>(w2c + C0 * T::RB + kk * 32), 1);
    out_pieces<T, C0 + N>(o, a, w2c, kk);
  }
}

template <class T>
__global__ void __launch_bounds__(256)
ffn_fwd_fused(const bf16* __restrict__ x, const unsigned char* __restrict__ packed,
              bf16* __restrict__ out, int R, int F) {
  constexpr int M = T::M, FC = T::FC, NH = T::NH, KS = FC / 16;
  constexpr int P = T::NST - 2;         // chunks in flight
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t landed[T::NST];
  const uint32_t xs = smem_base_1k(smem);   // x: M / 64 blocks of BR rows x 128 bytes
  const BulkRing<T> w{xs + T::XBYTES,
                      static_cast<uint32_t>(__cvta_generic_to_shared(landed)), packed};
  const int row0 = blockIdx.x * T::BR;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = F / FC;

  if (threadIdx.x == 0) w.start(P < nc ? P : nc);
  load_rows<T>(xs, x, row0, R);
  cp_async_commit();
  ring_landed<0>();   // x has landed; the barriers are initialised

  float o[M / 2];
#pragma unroll
  for (int i = 0; i < M / 2; ++i) o[i] = 0.f;
  uint32_t za[KS][4];                   // z of the previous chunk
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) za[kk][e] = 0u;

  for (int c = 0; c < nc; ++c) {
    const uint32_t st = w.stage(c);
    if (c > 0) __syncthreads();   // every warpgroup is done with chunk c - 2's stage
    if (threadIdx.x == 0 && c + P < nc) w.fill(c + P);
    w.wait(c);

    float h[NH / 2];
    wg_fence();
#pragma unroll 4
    for (int s = 0; s < M / 16; ++s)
      WgmmaSS<NH, 0, 0>::run(
          h, desc_sw<128>(xs + (s >> 2) * (T::BR * 128) + wg * 64 * 128 + (s & 3) * 32),
          desc_sw<128>(st + (s >> 2) * (2 * FC * 128) + (s & 3) * 32), s > 0);
    wg_commit();
    wg_wait<0>();      // h has landed, and the previous chunk's out product
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) reg_fence(h[i]);
#pragma unroll
    for (int i = 0; i < M / 2; ++i) reg_fence(o[i]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(za[kk][e]);

    // z = silu(h1) h3: n-tile j of h1 and n-tile j + FC / 8 of h3 hold the
    // same (row, f); n-tiles 2kk and 2kk + 1 are k-step kk of z.
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        za[kk][e] = pack_bf16(h[i] * sigmoid_fast(h[i]) * h[i + FC / 2],
                              h[i + 1] * sigmoid_fast(h[i + 1]) * h[i + 1 + FC / 2]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) out_pieces<T>(o, za[kk], st + T::W13, kk);
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < M / 2; ++i) reg_fence(o[i]);
  store_rows<T>(out, o, row0 + wg * 64 + 16 * warp + g, R, t);
}

// The fused instantiations. At M = 384 and 512 a warpgroup's 64 x M fp32
// output passes its registers; owning half the columns each, with z shared
// through shared memory in 16-column chunks, ran slower than the general
// route (PERF.md), which those widths take.
using Fwd128 = FusedFwd<128, 64, 3>;
using Fwd256 = FusedFwd<256, 32, 3>;

// ---- the fused bf16 backward rows at M = 128, 256 (ffn_bwd_rows): x and
// dout resident, the forward's chunks. Per chunk a warpgroup computes
// h1|h3 = x [W1c; W3c]^T and dz = dout W2c (W2c read MN-major from the same
// tile the forward reads K-major), forms dh1, dh3 and z in registers, writes
// them to the [R, 2F] and [R, F] scratches for the weight gradients, and
// accumulates dx += [dh1 dh3] [W1c; W3c] with [dh1 dh3] as register A and
// the W1|W3 tile read MN-major: dx never leaves registers (M / 2 a thread).
//
// The ring is refilled at the top of a chunk, NST - 2 chunks ahead (one at
// M = 256, where two stages fit beside x and dout). With NST >= 3, chunk c's
// dx product runs on the tensor cores while chunk c + 1's h and dz products
// are issued; with two stages the next copy overwrites its stage, so each
// chunk ends by waiting for it (loading chunk c + 1 after a second barrier
// in mid-chunk instead ran slower at M = 256). The stores of chunk c's dh1,
// dh3 and z read its A registers, so they follow the wait for that dx
// product (wgmma's A registers may not be touched before the wait that
// covers it) and run under chunk c + 1's h and dz products.
template <int M_, int FC_, int NST_>
struct BwdRows : ChunkTiles<M_, FC_, NST_> {
  using B = ChunkTiles<M_, FC_, NST_>;
  static constexpr int SMEM = 2 * B::XBYTES + NST_ * B::STAGE + 1024;
  static_assert(SMEM <= kSmemMax, "SwiGLU backward tiles exceed shared memory");
};

// a[j]: this lane's 4 bytes (columns 2t, 2t + 1) of n-tile j of a row held
// by a quad of lanes t = 0..3. Returns the 16 bytes of n-tile t: the pieces
// of lanes 0..3 of it, gathered by four xor-shuffles.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t a[4], int t) {
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = t ^ r;   // the n-tile lane t ^ r wants from this lane
    const uint32_t send = j == 0 ? a[0] : j == 1 ? a[1] : j == 2 ? a[2] : a[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = k == j ? got : b[k];
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// dx[64 x M] += a . W13c for k-step kk, in pieces of N = 128 (or 64).
template <class T, int C0 = 0>
__device__ __forceinline__ void dx_pieces(float* o, const uint32_t a[4], uint32_t w13, int kk) {
  if constexpr (C0 < T::M) {
    constexpr int N = T::M - C0 >= 128 ? 128 : 64;
    Wgmma<N, 1>::run(o + C0 / 2, a, desc_mn_sw(w13, 16 * kk, C0, 2 * T::FC * 128), 1);
    dx_pieces<T, C0 + N>(o, a, w13, kk);
  }
}

template <class T>
__global__ void __launch_bounds__(256)
ffn_bwd_rows(const bf16* __restrict__ x, const bf16* __restrict__ dout,
             const unsigned char* __restrict__ packed, bf16* __restrict__ dx,
             bf16* __restrict__ dh, bf16* __restrict__ z, int R, int F) {
  constexpr int M = T::M, FC = T::FC, NH = T::NH, KS = NH / 16, RB = T::RB;
  constexpr int NST = T::NST, P = NST > 2 ? NST - 2 : 1;   // P: chunks in flight
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t landed[NST];
  const uint32_t xs = smem_base_1k(smem);
  const uint32_t ds = xs + T::XBYTES;
  const BulkRing<T> w{ds + T::XBYTES,
                      static_cast<uint32_t>(__cvta_generic_to_shared(landed)), packed};
  const int row0 = blockIdx.x * T::BR;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = F / FC;

  if (threadIdx.x == 0) w.start(P < nc ? P : nc);
  load_rows<T>(xs, x, row0, R);
  load_rows<T>(ds, dout, row0, R);
  cp_async_commit();
  ring_landed<0>();   // x and dout have landed; the barriers are initialised

  float o[M / 2];                       // dx
#pragma unroll
  for (int i = 0; i < M / 2; ++i) o[i] = 0.f;
  uint32_t da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) da[kk][e] = 0u;
  const int r0 = row0 + wg * 64 + 16 * warp + g;

  // The stores of chunk cc's dh1, dh3 (its A fragments: n-tile n of row
  // half h is da[n / 2][2 (n % 2) + h]) and z, 16 bytes a lane: within each
  // quad of lanes (one row, 8 columns of each n-tile), lane t gathers n-tile
  // 4q + t of its rows.
  float zf[FC / 2];
  auto store = [&](int cc) {
    const int f0 = cc * FC;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
#pragma unroll
      for (int q = 0; q < FC / 32; ++q) {
        uint32_t p1[4], p3[4], pz[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n1 = 4 * q + j, n3 = n1 + FC / 8, e = 4 * n1 + 2 * half;
          p1[j] = da[n1 / 2][2 * (n1 % 2) + half];
          p3[j] = da[n3 / 2][2 * (n3 % 2) + half];
          pz[j] = pack_bf16(zf[e], zf[e + 1]);
        }
        const uint4 v1 = quad_transpose(p1, t), v3 = quad_transpose(p3, t),
                    vz = quad_transpose(pz, t);
        if (r < R) {
          const int f = f0 + 32 * q + 8 * t;
          bf16* row = dh + (long long)r * 2 * F;
          *reinterpret_cast<uint4*>(row + f) = v1;
          *reinterpret_cast<uint4*>(row + F + f) = v3;
          *reinterpret_cast<uint4*>(z + (long long)r * F + f) = vz;
        }
      }
    }
  };
  auto fence_dx = [&]() {
#pragma unroll
    for (int i = 0; i < M / 2; ++i) reg_fence(o[i]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(da[kk][e]);
  };

  for (int c = 0; c < nc; ++c) {
    const uint32_t st = w.stage(c);
    if (c > 0) __syncthreads();   // no warpgroup reads the stage refilled next
    if (threadIdx.x == 0 && c + P < nc) w.fill(c + P);
    w.wait(c);

    float h[NH / 2], dz[FC / 2];
    wg_fence();
#pragma unroll 4
    for (int s = 0; s < M / 16; ++s) {
      const uint32_t xo = (s >> 2) * (T::BR * 128) + wg * 64 * 128 + (s & 3) * 32;
      WgmmaSS<NH, 0, 0>::run(h, desc_sw<128>(xs + xo),
                             desc_sw<128>(st + (s >> 2) * (2 * FC * 128) + (s & 3) * 32), s > 0);
      WgmmaSS<FC, 0, 1>::run(dz, desc_sw<128>(ds + xo), desc_sw<RB>(st + T::W13 + 16 * s * RB),
                             s > 0);
    }
    wg_commit();
    if constexpr (NST > 2) {
      wg_wait<1>();    // the previous chunk's dx product, whose A registers store reads
      fence_dx();
    }                  // (with two stages, the end of that chunk waited for it)
    if (c > 0) store(c - 1);
    wg_wait<0>();      // h and dz have landed
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) reg_fence(h[i]);
#pragma unroll
    for (int i = 0; i < FC / 2; ++i) reg_fence(dz[i]);
    if constexpr (NST == 2) fence_dx();

    // n-tile j of h1, j + FC / 8 of h3 and j of dz hold the same (row, f).
    float d13[NH / 2];
#pragma unroll
    for (int i = 0; i < FC / 2; ++i)
      swiglu_grads(h[i], h[i + FC / 2], dz[i], d13[i], d13[i + FC / 2], zf[i]);
    // dx += [dh1 dh3] [W1c; W3c]: n-tiles 2kk, 2kk + 1 are k-step kk of A,
    // rounded to bf16 as the stored dh1 and dh3 are.
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        da[kk][e] = pack_bf16(d13[8 * kk + 2 * e], d13[8 * kk + 2 * e + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) dx_pieces<T>(o, da[kk], st, kk);
    wg_commit();
    if constexpr (NST == 2) wg_wait<0>();   // the next copy overwrites this stage
  }
  wg_wait<0>();
  fence_dx();
  if (nc > 0) store(nc - 1);
  store_rows<T>(dx, o, r0, R, t);
}

using Bwd128 = BwdRows<128, 32, 4>;
using Bwd256 = BwdRows<256, 32, 2>;

// ---- the bf16 general route (every width the gate takes but M = 128, 256):
// one warp-specialized, persistent kernel (ffn_ws) for the SwiGLU producers
// and the GEMMs. A block has three warpgroups. Warpgroup 0 keeps a ring of
// NST shared-memory stages full by TMA: one thread issues the copies (boxes
// zero-filled past a tensor's edge, in the swizzled layouts that desc_sw and
// desc_mn_sw read), counted on the stage's full mbarrier. Warpgroups 1 and 2
// each own 64 rows of a 128-row output tile; they run its products on wgmma
// as the stages land and release each stage on its empty mbarrier once the
// wgmmas that read it have completed (no block barrier per K-slice).
// setmaxnreg moves the producer's registers to the consumers. Blocks run in
// pairs (clusters of two) on neighbouring bands of rows: each loads half of a
// stage's B (weight-side) boxes and multicasts them to both, which halves the
// L2 reads of B, and a stage's empty barrier counts the consumers of both.
// One pair for two SMs walks the tiles in a fixed order, consecutive tiles on
// one band of rows, so that the band stays in L2; the producer loads the next
// tile while the consumers finish this one. Epilogues: the producers stage
// their bf16 outputs in shared memory and write them by TMA stores that drain
// under the next tile's products (their direct stores took a fifth of the
// backward producer's time); the GEMM stores 16 bytes a lane, gathered by
// quad shuffles (quad_transpose), whole 32-byte sectors.
//   FWD: h1 | h3 = x [W1; W3]^T over a 128-row x 128-column tile of F (one
//     product of N = 256: 128 fp32 accumulators a thread), z = silu(h1) h3 to
//     z [R, F] in bf16.
//   BWD: over a 128 x 128 tile of F, h1 | h3 (N = 256) and dz = dout W2
//     (N = 128, W2 read MN-major): 192 accumulators a thread (240 registers;
//     at 64 columns of F each operand byte fed half the products, and the
//     kernel ran 20% slower); dh1 | dh3 to dh [R, 2F] and z to z [R, F], bf16.
//   GEMM: up to three products a launch (the backward's dW1 | dW3 = dh^T x and
//     dW2 = dout^T z as row-split fp32 partials, and dx = dh [W1; W3]; the
//     forward's out = z W2^T), C tiles of 128 x BN, A and B each K-major or
//     MN-major (the descriptor's transpose bit); the weight gradients' long
//     tiles are walked first.
namespace ws {

constexpr int BOX = 64 * 128;            // bytes of a 64 x 64 bf16 box
constexpr int THREADS = 384;             // a producer and two consumer warpgroups
enum { GEMM = 0, FWD = 1, BWD = 2 };

// A stage holds one K-slice of KS = 32 columns: K-major operands in boxes of
// 64 rows x 64 bytes (the 64-byte swizzle), MN-major ones in boxes of 32
// K-rows x 64 columns (128 bytes, the 128-byte swizzle), 4 KB each. Narrow
// slices keep more of the ring in flight: a consumer warpgroup holds two
// stages (the slice its wgmmas read and the one before, until they complete).
// The consumers' registers: 232 a thread (240 for BWD's 192 accumulators),
// the producer's what the block's 168 a thread at launch leave over.
template <int MODE, int BN>
struct Cfg {
  static constexpr int KS = 32;
  static constexpr int KBOX = 64 * KS * 2;                       // a box
  static constexpr int A = 2 * KBOX;                             // 128 rows of A
  static constexpr int B = BN / 64 * KBOX;                       // BN rows or columns of B
  static constexpr int STAGE = MODE == BWD ? 2 * A + B + 2 * KBOX   // + dout, W2
                                           : A + B;
  // A consumer warpgroup's staging of its epilogue's stores: 64 rows x 128
  // columns of one (FWD: z) or two (BWD) outputs, in 64-column boxes.
  static constexpr int OUT = MODE == GEMM ? 0 : MODE == FWD ? 2 * BOX : 4 * BOX;
  static constexpr int FIT = (kSmemMax - 1024 - 2 * OUT) / STAGE;
  static constexpr int NST = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM = NST * STAGE + 2 * OUT + 1024;
  static constexpr int CONSUMER_REGS = MODE == BWD ? 240 : 232;
  static constexpr int PRODUCER_REGS = (THREADS * 168 - 256 * CONSUMER_REGS) / 128;
  static_assert(NST >= 3, "the ring needs three stages");
};

// One product of a GEMM launch: C[i, j] = sum_k A[i, k] B[k, j] over rows x
// cols (cols a multiple of BN), K split `splits` ways (k_per_split a
// multiple of 64); A[i, k] is the box element (k, i) of a when amn (MN-major),
// else (i, k), likewise B; B's K-rows from k_split on come from b2 (as row
// k - k_split). C in bf16, or (f32out) fp32 partials at c + split *
// split_stride. `units`: its tiles times its splits.
struct Prod {
  CUtensorMap a, b, b2;
  void* c;
  long long ldc, split_stride;
  int rows, cols, k, k_per_split, splits, k_split, amn, bmn, f32out, units;
};

struct Params {
  Prod p[3];                             // GEMM: its products, walked in order
  CUtensorMap x, w1, w3, dout, w2;       // FWD and BWD: their operands
  CUtensorMap zo, dho;                   // FWD and BWD: their outputs, stored by TMA
  int np, units, M, F, nft;              // nft: tiles of F (FWD and BWD)
};

// A cluster is a pair of blocks on neighbouring bands of 128 rows: they
// share the B (weight-side) boxes of a stage, each loading half and
// multicasting it to both. (Pairs along F sharing A as well, 2 x 2 blocks,
// ran slower.)
constexpr int PAIR = 2;

// A tile as block `rank` of its pair takes it: a pair's tile spans two bands
// of 128 rows, one a block.
struct Unit {
  const Prod* g;
  int i0, j0, kb, nk;
};

template <int MODE, int BN>
__device__ __forceinline__ Unit unit_of(const Params& p, int u, int rank) {
  Unit t{nullptr, 0, 0, 0, 0};
  if constexpr (MODE == GEMM) {
    int q = 0;
    while (q + 1 < p.np && u >= p.p[q].units) u -= p.p[q++].units;
    const Prod& g = p.p[q];
    const int tn = g.cols / BN, tiles = ((g.rows + 127) / 128 + PAIR - 1) / PAIR * tn;
    const int tile = u % tiles, split = u / tiles;
    t.g = &g;
    t.i0 = (tile / tn * PAIR + rank) * 128;
    t.j0 = tile % tn * BN;
    t.kb = split * g.k_per_split;
    const int ke = min(g.k, t.kb + g.k_per_split);
    t.nk = ke > t.kb ? (ke - t.kb + Cfg<MODE, BN>::KS - 1) / Cfg<MODE, BN>::KS : 0;
  } else {
    t.i0 = (u / p.nft * PAIR + rank) * 128;
    t.j0 = u % p.nft * 128;
    t.nk = p.M / Cfg<MODE, BN>::KS;
  }
  return t;
}

// The n-th tile a pair walks: a snake over the pairs, so that a pair that
// took one tile more in a round takes its neighbour's share of the next; -1
// past the last.
__device__ __forceinline__ int nth_unit(int n, int units, int pair, int pairs) {
  const int u = n * pairs + (n & 1 ? pairs - 1 - pair : pair);
  return u < units ? u : -1;
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// The same box into the same offset of both blocks of the pair, counted on
// each block's barrier at offset bar.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
        "h"((uint16_t)3)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}
// One arrival on the barrier at offset bar of block `rank` of the pair.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(bar), "r"(rank)
      : "memory");
}

// The producer's copies of K-slice k0 of tile t into stage s: its A-side
// boxes, and the B-side (weight) boxes b with b % 2 == rank, multicast to the
// pair.
template <int MODE, int BN>
__device__ __forceinline__ void load_stage(const Params& p, const Unit& t, int k0, uint32_t s,
                                           uint32_t bar, int rank) {
  using C = Cfg<MODE, BN>;
  auto weight = [&](uint32_t dst, const CUtensorMap* map, int c0, int c1, int b) {
    if (b % PAIR == rank) tma_load_multicast(dst, map, c0, c1, bar);
  };
  // The two boxes of a 128-row A-side tile at dst: K-major (box (k0, i0 +
  // 64 b)) or MN-major (box (i0 + 64 b, k0)).
  auto rows = [&](uint32_t dst, const CUtensorMap* map, int mn) {
    for (int b = 0; b < 2; ++b)
      tma_load(dst + b * C::KBOX, map, mn ? t.i0 + 64 * b : k0, mn ? k0 : t.i0 + 64 * b, bar);
  };
  if constexpr (MODE == GEMM) {
    const Prod& g = *t.g;
    rows(s, &g.a, g.amn);
    const bool lo = k0 < g.k_split;
    const CUtensorMap* bm = lo ? &g.b : &g.b2;
    const int kk = lo ? k0 : k0 - g.k_split;
    for (int b = 0; b < BN / 64; ++b) {
      const int col = t.j0 + 64 * b;
      weight(s + C::A + b * C::KBOX, bm, g.bmn ? col : kk, g.bmn ? kk : col, b);
    }
  } else {   // x; W1's 128 rows of the tile, then W3's; BWD: dout, W2's 128 columns
    rows(s, &p.x, 0);
    for (int b = 0; b < 4; ++b)
      weight(s + C::A + b * C::KBOX, b < 2 ? &p.w1 : &p.w3, k0, t.j0 + 64 * (b & 1), b);
    if constexpr (MODE == BWD) {
      const uint32_t s2 = s + C::A + C::B;
      rows(s2, &p.dout, 0);
      for (int b = 0; b < 2; ++b)   // MN-major: boxes of 64 columns x 32 K-rows
        weight(s2 + C::A + b * C::KBOX, &p.w2, t.j0 + 64 * b, k0, 4 + b);
    }
  }
}

// The stages of a consumer warpgroup's K-loop: wait for each to land, issue
// its wgmmas (mma(stage)), and release the previous one once its wgmmas have
// completed, to both blocks of the pair (either one's multicast copies land
// in it); `st` and `ph` run on over the tiles.
template <int NST, class Mma>
__device__ __forceinline__ void consume(int nk, uint32_t ring, int stage_bytes, uint32_t full,
                                        uint32_t empty, int& st, uint32_t& ph, Mma mma) {
  auto release = [&](int stage) {
    if ((threadIdx.x & 127) == 0)
      for (int r = 0; r < PAIR; ++r) mbar_arrive_at(empty + 8 * stage, r);
  };
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(full + 8 * st, ph);
    wg_fence();
    mma(ring + st * stage_bytes);
    wg_commit();
    wg_wait<1>();
    if (prev >= 0) release(prev);
    prev = st;
    if (++st == NST) {
      st = 0;
      ph ^= 1;
    }
  }
  wg_wait<0>();
  if (prev >= 0) release(prev);
}

// Stores 16 bytes of row `row` (its columns 32 q .. 32 q + 31 from row on):
// p[j] holds this lane's two columns of n-tile 4 q + j; lane t of the quad
// stores n-tile 4 q + t. Every lane of the warp takes part.
__device__ __forceinline__ void store16(bf16* row, const uint32_t p[4], int t, bool ok) {
  const uint4 v = quad_transpose(p, t);
  if (ok) *reinterpret_cast<uint4*>(row + 8 * t) = v;
}

// The bf16 pair v at (row r, column c, c even) of a staged tile of 64-column
// boxes of 64 rows x 128 bytes, in the 128-byte swizzle (conflict-free for a
// warp's accumulator fragment: its 8 rows land on 8 distinct 16-byte chunks).
__device__ __forceinline__ void st_staged(uint32_t tile, int r, int c, uint32_t v) {
  const uint32_t a =
      tile + (c >> 6) * BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
// The consumer warpgroup's staged epilogue: its 128 threads meet at named
// barrier 1 + wc; one thread issues the TMA stores, which drain while the
// warpgroup goes on to the next tile's products, and waits for the stores'
// reads of the staging before the warpgroup writes it again.
struct Staged {
  uint32_t tile;
  int wc;
  bool leader;
  __device__ void sync() const { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wc) : "memory"); }
  __device__ void reusable() const {   // the previous stores have read the staging
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    sync();
  }
  __device__ void written() const {    // the staging is written: visible to the stores
    fence_proxy_async();
    sync();
  }
  // Boxes b = 0, 1 of the staged tile at offset `from` to columns c0 + 64 b,
  // rows r0 .. r0 + 63 of the output `map` (rows past its end are not written).
  __device__ void store(const CUtensorMap* map, uint32_t from, int c0, int r0) const {
    if (!leader) return;
    for (int b = 0; b < 2; ++b) tma_store(map, tile + from + b * BOX, c0 + 64 * b, r0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
};

// acc (this warpgroup's 64 rows x N) += A B over one K-slice of 32: A's
// rows 64 wc .. from the tile at sa, B's N rows (or columns) at sb, each
// K-major (64-byte rows) or MN-major (TA, TB: 64-column boxes of 32 K-rows).
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_slice(float* acc, uint32_t sa, uint32_t sb, int wc) {
  constexpr int KBOX = 64 * 32 * 2;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    WgmmaSS<N, TA, TB>::run(
        acc, TA ? desc_mn_sw(sa, 16 * k, 64 * wc, KBOX) : desc_sw<64>(sa + 64 * wc * 64 + 32 * k),
        TB ? desc_mn_sw(sb, 16 * k, 0, KBOX) : desc_sw<64>(sb + 32 * k), 1);
}

template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS, 1) ffn_ws(const __grid_constant__ Params p) {
  using C = Cfg<MODE, BN>;
  constexpr int NST = C::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * NST];   // full, then empty
  const uint32_t ring = smem_base_1k(smem);
  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t empty = full + 8 * NST;
  const int rank = (int)cluster_rank();
  const int pair = blockIdx.x / PAIR, pairs = gridDim.x / PAIR;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * PAIR);   // two consumer warpgroups a block
    }
    fence_mbar_init();
  }
  cluster_sync();   // no block's copies reach a barrier before it is initialised

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      int st = 0;
      uint32_t ph = 0;
      for (int n = 0;; ++n) {
        const int u = nth_unit(n, p.units, pair, pairs);
        if (u < 0) break;
        const Unit t = unit_of<MODE, BN>(p, u, rank);
        for (int kt = 0; kt < t.nk; ++kt) {
          mbar_wait(empty + 8 * st, ph ^ 1);
          mbar_expect_tx(full + 8 * st, C::STAGE);
          load_stage<MODE, BN>(p, t, t.kb + C::KS * kt, ring + st * C::STAGE, full + 8 * st,
                               rank);
          if (++st == NST) {
            st = 0;
            ph ^= 1;
          }
        }
      }
      // Every stage released before the block exits: the other block of the
      // pair arrives on this one's barriers.
      for (int i = 0; i < NST; ++i) {
        mbar_wait(empty + 8 * st, ph ^ 1);
        if (++st == NST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS) : "memory");
    const int wc = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t4 = lane & 3;
    const int rl = 16 * warp + (lane >> 2);   // this thread's first row of its 64
    const Staged out{ring + NST * C::STAGE + wc * C::OUT, wc, (threadIdx.x & 127) == 0};
    int st = 0;
    uint32_t ph = 0;
    for (int n = 0;; ++n) {
      const int u = nth_unit(n, p.units, pair, pairs);
      if (u < 0) break;
      const Unit t = unit_of<MODE, BN>(p, u, rank);
      if constexpr (MODE == GEMM) {
        const Prod& g = *t.g;
        const int r0 = t.i0 + 64 * wc + rl;
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        auto run = [&](auto mma) {
          consume<NST>(t.nk, ring, C::STAGE, full, empty, st, ph, mma);
        };
        if (g.amn)
          run([&](uint32_t s) { mma_slice<BN, 1, 1>(acc, s, s + C::A, wc); });
        else if (g.bmn)
          run([&](uint32_t s) { mma_slice<BN, 0, 1>(acc, s, s + C::A, wc); });
        else
          run([&](uint32_t s) { mma_slice<BN, 0, 0>(acc, s, s + C::A, wc); });
        fence_all<BN / 2>(acc);
        if (g.f32out) {
          float* c = static_cast<float*>(g.c) + (long long)(t.kb / g.k_per_split) * g.split_stride;
#pragma unroll
          for (int nn = 0; nn < BN / 8; ++nn) {
            const int col = t.j0 + 8 * nn + 2 * t4;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = r0 + 8 * hf;
              if (r < g.rows)
                *reinterpret_cast<float2*>(c + (long long)r * g.ldc + col) =
                    make_float2(acc[4 * nn + 2 * hf], acc[4 * nn + 2 * hf + 1]);
            }
          }
        } else {
          bf16* c = static_cast<bf16*>(g.c);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            bf16* row = c + (long long)min(r, g.rows - 1) * g.ldc + t.j0;
#pragma unroll
            for (int q = 0; q < BN / 32; ++q) {
              uint32_t pk[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int e = 4 * (4 * q + j) + 2 * hf;
                pk[j] = pack_bf16(acc[e], acc[e + 1]);
              }
              store16(row + 32 * q, pk, t4, r < g.rows);
            }
          }
        }
      } else if constexpr (MODE == FWD) {
        float h[128];   // n-tile n: h1 at column f0 + 8 n; n + 16: h3
#pragma unroll
        for (int i = 0; i < 128; ++i) h[i] = 0.f;
        consume<NST>(t.nk, ring, C::STAGE, full, empty, st, ph, [&](uint32_t s) {
          mma_slice<256, 0, 0>(h, s, s + C::A, wc);
        });
        fence_all<128>(h);
        out.reusable();
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 4 * n + 2 * hf;
            st_staged(out.tile, rl + 8 * hf, 8 * n + 2 * t4,
                      pack_bf16(h[e] * sigmoid_fast(h[e]) * h[e + 64],
                                h[e + 1] * sigmoid_fast(h[e + 1]) * h[e + 65]));
          }
        out.written();
        out.store(&p.zo, 0, t.j0, t.i0 + 64 * wc);
      } else {
        float h[128], dz[64];   // n-tile n: h1 at f0 + 8 n, n + 16: h3; dz at f0 + 8 n
#pragma unroll
        for (int i = 0; i < 128; ++i) h[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 64; ++i) dz[i] = 0.f;
        consume<NST>(t.nk, ring, C::STAGE, full, empty, st, ph, [&](uint32_t s) {
          const uint32_t sd = s + C::A + C::B;
          mma_slice<256, 0, 0>(h, s, s + C::A, wc);
          mma_slice<128, 0, 1>(dz, sd, sd + C::A, wc);
        });
        fence_all<128>(h);
        fence_all<64>(dz);
        // dh1 and dh3 staged and stored, then z in dh1's place.
        uint32_t zp[32];
        out.reusable();
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 4 * n + 2 * hf, r = rl + 8 * hf, col = 8 * n + 2 * t4;
            float d1[2], d3[2], zz[2];
#pragma unroll
            for (int v = 0; v < 2; ++v)
              swiglu_grads(h[e + v], h[e + 64 + v], dz[e + v], d1[v], d3[v], zz[v]);
            st_staged(out.tile, r, col, pack_bf16(d1[0], d1[1]));
            st_staged(out.tile + 2 * BOX, r, col, pack_bf16(d3[0], d3[1]));
            zp[2 * n + hf] = pack_bf16(zz[0], zz[1]);
          }
        out.written();
        out.store(&p.dho, 0, t.j0, t.i0 + 64 * wc);
        out.store(&p.dho, 2 * BOX, p.F + t.j0, t.i0 + 64 * wc);
        out.reusable();
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            st_staged(out.tile, rl + 8 * hf, 8 * n + 2 * t4, zp[2 * n + hf]);
        out.written();
        out.store(&p.zo, 0, t.j0, t.i0 + 64 * wc);
      }
    }
    if (out.leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace ws

// ---- fp32: every product as three tf32 wgmmas of split operands
// (tf32_split.cuh: hi = tf32(x), lo = tf32(x - hi), A B = A_lo B_hi +
// A_hi B_lo + A_hi B_hi), both operands K-major in shared memory. A tile
// has 128 rows; an item is a 32-column chunk of K of an A tile and a B tile,
// hi and lo of each (64 KB), streamed through a three-stage ring; each item's
// products go to a fresh accumulator that one rounded fp32 add takes into
// the running sums (a wgmma's own additions are not rounded to nearest, and
// the weight gradients sum over all R rows).
namespace f32 {

using namespace tf32;

constexpr int TR = 128;                  // rows of an A, B or C tile
constexpr int TILE = TR * ROW_BYTES;     // 16 KB: a 32-column chunk of 128 rows
constexpr int ITEM = 4 * TILE;           // A hi, A lo, B hi, B lo
constexpr int SMEM = 3 * ITEM + 1024;
static_assert(SMEM <= kSmemMax, "the fp32 stages exceed shared memory");
constexpr int FC = 64;                   // columns of F a producer tile owns

// part (64 x N a warpgroup: rows 64 wg .. of the item's A tile against the
// first N rows of its B tile) = A B over the item's 32 columns.
template <int N>
__device__ __forceinline__ void mma_item(float* part, uint32_t st, int wg) {
  const uint32_t ah = st, al = st + TILE, bh = st + 2 * TILE, bl = st + 3 * TILE;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    WgmmaTF32<N>::run(part, kmajor(al, 64 * wg, kk), kmajor(bh, 0, kk), kk > 0);
    WgmmaTF32<N>::run(part, kmajor(ah, 64 * wg, kk), kmajor(bl, 0, kk), 1);
    WgmmaTF32<N>::run(part, kmajor(ah, 64 * wg, kk), kmajor(bh, 0, kk), 1);
  }
}

template <int V>
__device__ __forceinline__ void add_part(float* acc, float* part) {
  fence_all<V>(part);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += part[i];
}

template <int V>
__device__ __forceinline__ void zero(float* acc) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// ---- the GEMM: C[i, j] = sum_k A[i, k] B[j, k] over one 128 x 128 tile of
// C and the K range of one split (a multiple of 32 long, but for the last);
// A [rows, k] and B [cols, k] K-major, row strides lda and ldb; C at
// c + split * split_stride, row stride ldc. cols is a multiple of 128.
struct Prod {
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  float* c;
  long long ldc, split_stride;
  int rows, cols, k, k_per_split, splits;
};
// Up to three products in one launch: blocks from start[q] on take product
// q's tiles, one split after another; neighbouring blocks share a row of C
// tiles, so its A comes from device memory once.
struct Prods {
  Prod p[3];
  int start[3];
};

__global__ void __launch_bounds__(256, 1) ffn_tf32_gemm(Prods ps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);
  const int bx = blockIdx.x;
  Prod g = ps.p[0];
  int local = bx;
  if (bx >= ps.start[2]) {
    g = ps.p[2];
    local = bx - ps.start[2];
  } else if (bx >= ps.start[1]) {
    g = ps.p[1];
    local = bx - ps.start[1];
  }
  const int tn = g.cols / TR, tiles = (g.rows + TR - 1) / TR * tn;
  const int split = local / tiles, tile = local % tiles;
  const int i0 = tile / tn * TR, j0 = tile % tn * TR;
  const int kb = split * g.k_per_split, ke = min(g.k, kb + g.k_per_split);
  const int n = ke > kb ? (ke - kb + 31) / 32 : 0;
  const int wg = threadIdx.x >> 7;

  float acc[64], part[64];
  zero<64>(acc);
  zero<64>(part);
  auto load = [&](int i, uint32_t st) {
    const int k0 = kb + 32 * i;
    copy_chunk<TR>(st, g.a + (long long)i0 * g.lda + k0, g.lda, g.rows - i0, ke - k0);
    copy_chunk<TR>(st + 2 * TILE, g.b + (long long)j0 * g.ldb + k0, g.ldb, g.cols - j0,
                   ke - k0);
  };
  auto split_item = [&](int, uint32_t st) {
    split_chunk<TR>(st, st + TILE);
    split_chunk<TR>(st + 2 * TILE, st + 3 * TILE);
  };
  if (n > 0) {   // an empty split writes zeros
    auto rg = make_ring(sbase, ITEM, n, load, split_item);
    rg.start();
    for (int i = 0; i < n; ++i)
      rg.step([&](uint32_t st) { mma_item<TR>(part, st, wg); },
              [&](uint32_t) { add_part<64>(acc, part); });
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = i0 + 64 * wg + 16 * warp + (lane >> 2), r1 = r0 + 8;
  float* c = g.c + (long long)split * g.split_stride;
#pragma unroll
  for (int nn = 0; nn < TR / 8; ++nn) {
    const int col = j0 + 8 * nn + 2 * (lane & 3);
    if (r0 < g.rows)
      *reinterpret_cast<float2*>(c + (long long)r0 * g.ldc + col) =
          make_float2(acc[4 * nn], acc[4 * nn + 1]);
    if (r1 < g.rows)
      *reinterpret_cast<float2*>(c + (long long)r1 * g.ldc + col) =
          make_float2(acc[4 * nn + 2], acc[4 * nn + 3]);
  }
}

// ---- the producer: for a block's 128 rows of x and `tiles` tiles of FC
// columns of F from tile blockIdx.x * tiles on, h1 | h3 = x [W1; W3]^T (one
// product of N = 128: the tile's 64 rows of W1, then of W3) over K = M,
// then, backward, dz = dout W2 (the tile's 64 rows of W2^T, N = 64). The
// SwiGLU runs in fp32 in the epilogue. Forward: z = silu(h1) h3 to z [R, F].
// Backward: dh1 | dh3 to dh [R, 2F] (the dx product's A), and dh1 | dh3 and
// z transposed to dht [2F, Rp] and zt [F, Rp] (the weight gradients' K = R
// operands; rows R .. Rp - 1 are zero, as x's and dout's rows past R are
// zero-filled). A warp's transposed stores fill whole 32-byte sectors.
template <int BWD>
__global__ void __launch_bounds__(256, 1)
ffn_tf32_produce(const float* __restrict__ x, const float* __restrict__ dout,
                 const float* __restrict__ w1, const float* __restrict__ w3,
                 const float* __restrict__ w2t, float* __restrict__ z,
                 float* __restrict__ dh, float* __restrict__ dht, float* __restrict__ zt,
                 int R, int Rp, int M, int F, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_base_1k(smem);
  const int i0 = blockIdx.y * TR, t0 = blockIdx.x * tiles;
  const int nt = min(tiles, F / FC - t0);
  const int nk = M / 32, per = BWD ? 2 * nk : nk;   // items of a tile
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = i0 + 64 * wg + 16 * warp + (lane >> 2);
  constexpr int DZ = BWD ? 32 : 1;

  float h[64], dz[DZ], part[64];
  zero<64>(h);
  zero<DZ>(dz);
  zero<64>(part);
  auto load = [&](int i, uint32_t st) {
    const int r = i % per, f0 = (t0 + i / per) * FC;
    const int k0 = 32 * (r < nk ? r : r - nk);
    copy_chunk<TR>(st, (r < nk ? x : dout) + (long long)i0 * M + k0, M, R - i0, 32);
    if (r < nk) {
      copy_chunk<FC>(st + 2 * TILE, w1 + (long long)f0 * M + k0, M, FC, 32);
      copy_chunk<FC>(st + 2 * TILE + FC * ROW_BYTES, w3 + (long long)f0 * M + k0, M, FC, 32);
    } else {
      copy_chunk<FC>(st + 2 * TILE, w2t + (long long)f0 * M + k0, M, FC, 32);
    }
  };
  // split_chunk<TR> splits the pieces the two copy_chunk<FC> of W1 and W3
  // gave this thread: rows r and r + 32 of each are its rows r + 32 m.
  auto split_item = [&](int i, uint32_t st) {
    split_chunk<TR>(st, st + TILE);
    if (i % per < nk)
      split_chunk<TR>(st + 2 * TILE, st + 3 * TILE);
    else
      split_chunk<FC>(st + 2 * TILE, st + 3 * TILE);
  };
  // n-tile nn of h1 and nn + 8 of h3 (and nn of dz) hold the same (row, f).
  auto epilogue = [&](int f0) {
#pragma unroll
    for (int nn = 0; nn < FC / 8; ++nn) {
      const int f = f0 + 8 * nn + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, e = 4 * nn + 2 * half;
        if constexpr (BWD) {
          float d1[2], d3[2], zz[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float h1 = h[e + u], h3 = h[e + 32 + u], d = dz[e + u];
            const float sg = sigmoid(h1);
            d1[u] = d * h3 * (sg * (1.f + h1 * (1.f - sg)));
            d3[u] = d * h1 * sg;
            zz[u] = h1 * sg * h3;
          }
          if (r < R) {
            float* row = dh + (long long)r * 2 * F;
            *reinterpret_cast<float2*>(row + f) = make_float2(d1[0], d1[1]);
            *reinterpret_cast<float2*>(row + F + f) = make_float2(d3[0], d3[1]);
          }
          if (r < Rp) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              dht[(long long)(f + u) * Rp + r] = d1[u];
              dht[(long long)(F + f + u) * Rp + r] = d3[u];
              zt[(long long)(f + u) * Rp + r] = zz[u];
            }
          }
        } else if (r < R) {
          *reinterpret_cast<float2*>(z + (long long)r * F + f) =
              make_float2(h[e] * sigmoid(h[e]) * h[e + 32],
                          h[e + 1] * sigmoid(h[e + 1]) * h[e + 33]);
        }
      }
    }
  };

  const int n = nt * per;
  auto rg = make_ring(sbase, ITEM, n, load, split_item);
  rg.start();
  for (int i = 0; i < n; ++i) {
    const int r = i % per;
    rg.step(
        [&](uint32_t st) {
          if (r < nk)
            mma_item<2 * FC>(part, st, wg);
          else if constexpr (BWD)
            mma_item<FC>(part, st, wg);
        },
        [&](uint32_t) {
          if (r < nk)
            add_part<64>(h, part);
          else if constexpr (BWD)
            add_part<32>(dz, part);
          if (r == per - 1) {
            epilogue((t0 + i / per) * FC);
            zero<64>(h);
            zero<DZ>(dz);
          }
        });
  }
}

// ---- dst[c, r] = src[r, c] for c < cols and r < rows_pad (zero from
// rows on), a 32 x 32 tile a block through shared memory; up to five jobs a
// launch, blocks from start[q] on taking job q's tiles.
struct TJob {
  const float* src;
  float* dst;
  long long lds, ldd;
  int rows, rows_pad, cols;
};
struct TJobs {
  TJob j[5];
  int start[5];
};

__global__ void __launch_bounds__(256) ffn_tf32_transpose(TJobs js) {
  __shared__ float tile[32][33];
  TJob jb = js.j[0];
  int local = blockIdx.x;
#pragma unroll
  for (int q = 1; q < 5; ++q)
    if ((int)blockIdx.x >= js.start[q]) {
      jb = js.j[q];
      local = blockIdx.x - js.start[q];
    }
  const int tc = (jb.cols + 31) / 32;
  const int r0 = local / tc * 32, c0 = local % tc * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = r < jb.rows && c < jb.cols ? jb.src[(long long)r * jb.lds + c] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < jb.cols && r < jb.rows_pad) jb.dst[(long long)c * jb.ldd + r] = tile[tx][i];
  }
}

}  // namespace f32

// out[i] = sum over the splits of part[split][i], in split order.
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

// ---- launches
int grid_1d(long long n) { return (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096); }

int k_per_split(int k, int splits, int step) {
  const int per = (k + splits - 1) / splits;
  return (per + step - 1) / step * step;
}

template <int BN>
cudaError_t gemm_bn(GemmArgs g0, GemmArgs g1, int splits, cudaStream_t s) {
  constexpr int smem = GemmTile<BN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(ffn_gemm<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  g0.k_per_split = k_per_split(g0.k, splits, 64);
  g1.k_per_split = k_per_split(g1.k, splits, 64);
  auto tiles = [](const GemmArgs& g) { return (g.rows + GT - 1) / GT * (g.cols / BN); };
  const int t0 = tiles(g0);
  ffn_gemm<BN><<<dim3(t0 + tiles(g1), 1, splits), 256, smem, s>>>(g0, g1, t0);
  return cudaGetLastError();
}

// The fused route's two weight-gradient products in one launch, C tiles of
// 256 columns where both products' columns allow it, else 128.
cudaError_t wgrad_gemm(GemmArgs g0, GemmArgs g1, int splits, cudaStream_t s) {
  const bool wide = g0.cols % 256 == 0 && g1.cols % 256 == 0;
  return wide ? gemm_bn<256>(g0, g1, splits, s) : gemm_bn<128>(g0, g1, splits, s);
}

// fp32: up to three products in one launch, each split p.splits ways
// along K in multiples of 32.
cudaError_t tf32_gemm(f32::Prod* p, int np, cudaStream_t s) {
  f32::Prods ps{};
  int blocks = 0;
  for (int q = 0; q < 3; ++q) {
    ps.start[q] = q < np ? blocks : INT_MAX;
    if (q >= np) continue;
    p[q].k_per_split = k_per_split(p[q].k, p[q].splits, 32);
    ps.p[q] = p[q];
    blocks += (p[q].rows + f32::TR - 1) / f32::TR * (p[q].cols / f32::TR) * p[q].splits;
  }
  cudaError_t err = cudaFuncSetAttribute(
      f32::ffn_tf32_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, f32::SMEM);
  if (err != cudaSuccess) return err;
  f32::ffn_tf32_gemm<<<blocks, 256, f32::SMEM, s>>>(ps);
  return cudaGetLastError();
}

// fp32 producer: a block walks `tiles` tiles of F, as many as leave about
// four blocks an SM.
template <int BWD>
cudaError_t tf32_produce(const float* x, const float* dout, const float* w1, const float* w3,
                         const float* w2t, float* z, float* dh, float* dht, float* zt, int R,
                         int Rp, int M, int F, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nft = F / f32::FC, rt = (R + f32::TR - 1) / f32::TR;
  int tiles = nft;
  while (tiles > 1 && (long long)rt * ((nft + tiles - 1) / tiles) < 4LL * sms)
    tiles = (tiles + 1) / 2;
  err = cudaFuncSetAttribute(f32::ffn_tf32_produce<BWD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, f32::SMEM);
  if (err != cudaSuccess) return err;
  f32::ffn_tf32_produce<BWD><<<dim3((nft + tiles - 1) / tiles, rt), 256, f32::SMEM, s>>>(
      x, dout, w1, w3, w2t, z, dh, dht, zt, R, Rp, M, F, tiles);
  return cudaGetLastError();
}

cudaError_t tf32_transpose(const f32::TJob* jobs, int nj, cudaStream_t s) {
  f32::TJobs js{};
  int blocks = 0;
  for (int q = 0; q < 5; ++q) {
    js.start[q] = q < nj ? blocks : INT_MAX;
    if (q >= nj) continue;
    js.j[q] = jobs[q];
    blocks += (jobs[q].rows_pad + 31) / 32 * ((jobs[q].cols + 31) / 32);
  }
  f32::ffn_tf32_transpose<<<blocks, 256, 0, s>>>(js);
  return cudaGetLastError();
}

// Rows of the transposed K = R operands: R rounded up to 32 (128 bytes).
long long rows_padded(int R) { return (R + 31LL) / 32 * 32; }

// packed: the weights' chunk images, 3 F M bf16.
template <class T>
cudaError_t bwd_rows(const bf16* x, const bf16* dout, const bf16* w1, const bf16* w3,
                     const bf16* w2, unsigned char* packed, bf16* dx, bf16* dh, bf16* z,
                     int R, int F, cudaStream_t s) {
  ffn_pack_w<T><<<F / T::FC, 256, 0, s>>>(w1, w3, w2, packed, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ffn_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (err != cudaSuccess) return err;
  ffn_bwd_rows<T><<<(R + T::BR - 1) / T::BR, 256, T::SMEM, s>>>(x, dout, packed, dx, dh, z,
                                                                 R, F);
  return cudaGetLastError();
}

// packed: the weights' chunk images, 3 F M bf16.
template <class T>
cudaError_t fwd_fused(const bf16* x, const bf16* w1, const bf16* w3, const bf16* w2,
                      unsigned char* packed, bf16* out, int R, int F, cudaStream_t s) {
  ffn_pack_w<T><<<F / T::FC, 256, 0, s>>>(w1, w3, w2, packed, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ffn_fwd_fused<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (err != cudaSuccess) return err;
  ffn_fwd_fused<T><<<(R + T::BR - 1) / T::BR, 256, T::SMEM, s>>>(x, packed, out, R, F);
  return cudaGetLastError();
}

#define RETURN_IF(e)                          \
  do {                                        \
    cudaError_t e_ = (e);                     \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

bool fused(int M) { return M == 128 || M == 256; }

namespace ws {

#define WS_TRY(e)                             \
  do {                                        \
    const cudaError_t e_ = (e);               \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so that the library links the CUDA runtime alone.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                            &q) == cudaSuccess &&
                    q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A contiguous bf16 [rows, cols] tensor as boxes of `width` columns (64 in
// the 128-byte swizzle, 32 in the 64-byte one) by `height` rows, read as
// zeros past its edges (and not written there).
cudaError_t tensor_map(CUtensorMap* m, const void* p, long long rows, long long cols,
                       int width, int height) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)width, (cuuint32_t)height}, step[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dim,
                         stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An operand's boxes of one K-slice: K-major (a tensor row is a tile row)
// or MN-major (a tensor row is a K-row); an output's 64 x 64 boxes.
cudaError_t kmajor(CUtensorMap* m, const void* p, long long rows, long long cols) {
  return tensor_map(m, p, rows, cols, 32, 64);
}
cudaError_t mnmajor(CUtensorMap* m, const void* p, long long rows, long long cols) {
  return tensor_map(m, p, rows, cols, 64, 32);
}
cudaError_t output(CUtensorMap* m, const void* p, long long rows, long long cols) {
  return tensor_map(m, p, rows, cols, 64, 64);
}

// Tiles of pairs of blocks over `rows` rows (two bands of 128 a tile) and
// `cols` column tiles.
int pair_tiles(long long rows, int cols) {
  return (int)(((rows + 127) / 128 + PAIR - 1) / PAIR * cols);
}

template <int MODE, int BN>
cudaError_t launch(const Params& p, cudaStream_t s) {
  using C = Cfg<MODE, BN>;
  cudaError_t err = cudaFuncSetAttribute(ffn_ws<MODE, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess || p.units == 0) return err;
  int dev = 0, sms = 132;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms / PAIR * PAIR);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = PAIR;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  // One pair for each that fits on the card at once, or for each tile.
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, ffn_ws<MODE, BN>, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((fit < p.units ? fit : p.units) * PAIR);
  err = cudaLaunchKernelEx(&cfg, ffn_ws<MODE, BN>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The GEMM launch of g's products, C tiles of 128 x bn.
cudaError_t gemm_launch(Params& g, int bn, cudaStream_t s) {
  g.units = 0;
  for (int q = 0; q < g.np; ++q) {
    Prod& d = g.p[q];
    d.k_per_split = k_per_split(d.k, d.splits, 64);
    d.units = pair_tiles(d.rows, d.cols / bn) * d.splits;
    g.units += d.units;
  }
  return bn == 256 ? launch<GEMM, 256>(g, s) : launch<GEMM, 128>(g, s);
}

// Forward: z = silu(x W1^T) (x W3^T) to the scratch, then out = z W2^T.
cudaError_t forward(const bf16* x, const bf16* w1, const bf16* w3, const bf16* w2, bf16* z,
                    bf16* out, int R, int M, int F, cudaStream_t s) {
  Params p{};
  WS_TRY(kmajor(&p.x, x, R, M));
  WS_TRY(kmajor(&p.w1, w1, F, M));
  WS_TRY(kmajor(&p.w3, w3, F, M));
  WS_TRY(output(&p.zo, z, R, F));
  p.M = M;
  p.F = F;
  p.nft = F / 128;
  p.units = pair_tiles(R, p.nft);
  WS_TRY((launch<FWD, 256>(p, s)));
  Params g{};
  Prod& o = g.p[0];   // out = z W2^T: W2 [M, F] is the K-major B
  WS_TRY(kmajor(&o.a, z, R, F));
  WS_TRY(kmajor(&o.b, w2, M, F));
  o.b2 = o.b;
  o.c = out;
  o.ldc = M;
  o.rows = R;
  o.cols = M;
  o.k = F;
  o.splits = 1;
  o.k_split = INT_MAX;
  g.np = 1;
  return gemm_launch(g, M % 256 == 0 ? 256 : 128, s);
}

// Backward: dh1 | dh3 and z to the scratches; then, in one launch, the
// weight gradients' row-split partials and dx.
cudaError_t backward(const bf16* x, const bf16* dout, const bf16* w1, const bf16* w3,
                     const bf16* w2, bf16* dh, bf16* z, bf16* dx, float* part, int R, int M,
                     int F, int splits, cudaStream_t s) {
  Params p{};
  WS_TRY(kmajor(&p.x, x, R, M));
  WS_TRY(kmajor(&p.w1, w1, F, M));
  WS_TRY(kmajor(&p.w3, w3, F, M));
  WS_TRY(kmajor(&p.dout, dout, R, M));
  WS_TRY(mnmajor(&p.w2, w2, M, F));   // dz = dout W2 reads W2 MN-major
  WS_TRY(output(&p.zo, z, R, F));
  WS_TRY(output(&p.dho, dh, R, 2LL * F));
  p.M = M;
  p.F = F;
  p.nft = F / 128;
  p.units = pair_tiles(R, p.nft);
  WS_TRY((launch<BWD, 256>(p, s)));

  const long long fm = (long long)F * M;
  Params g{};
  Prod &w13 = g.p[0], &w2g = g.p[1], &dxg = g.p[2];
  // dW1 | dW3 [2F, M] = dh^T x, both MN-major (K = R).
  WS_TRY(mnmajor(&w13.a, dh, R, 2LL * F));
  WS_TRY(mnmajor(&w13.b, x, R, M));
  w13.b2 = w13.b;
  w13.c = part;
  w13.ldc = M;
  w13.split_stride = 3 * fm;
  w13.rows = 2 * F;
  w13.cols = M;
  // dW2 [M, F] = dout^T z.
  WS_TRY(mnmajor(&w2g.a, dout, R, M));
  WS_TRY(mnmajor(&w2g.b, z, R, F));
  w2g.b2 = w2g.b;
  w2g.c = part + 2 * fm;
  w2g.ldc = F;
  w2g.split_stride = 3 * fm;
  w2g.rows = M;
  w2g.cols = F;
  auto wgrad = [&](Prod& q) {
    q.k = R;
    q.splits = splits;
    q.k_split = INT_MAX;
    q.amn = q.bmn = q.f32out = 1;
  };
  wgrad(w13);
  wgrad(w2g);
  // dx [R, M] = [dh1 dh3] [W1; W3]: dh K-major, B's K-rows from W1, then W3.
  WS_TRY(kmajor(&dxg.a, dh, R, 2LL * F));
  WS_TRY(mnmajor(&dxg.b, w1, F, M));
  WS_TRY(mnmajor(&dxg.b2, w3, F, M));
  dxg.k_split = F;
  dxg.bmn = 1;
  dxg.c = dx;
  dxg.ldc = M;
  dxg.rows = R;
  dxg.cols = M;
  dxg.k = 2 * F;
  dxg.splits = 1;
  g.np = 3;
  return gemm_launch(g, M % 256 == 0 && F % 256 == 0 ? 256 : 128, s);
}

}  // namespace ws

}  // namespace

// Scratch the forward (bwd = 0) or backward needs, in bytes: the bf16
// fused forward keeps the packed weights (3 F M), the general one z [R, F];
// the bf16 backward dh1|dh3 [R, 2F] and z [R, F], then at the fused widths
// the packed weights. fp32 forward: z [R, F]; fp32 backward: dh1|dh3
// [R, 2F], its transpose [2F, Rp] and z's [F, Rp], x's and dout's
// transposes [M, Rp], W2^T [F, M] and [W1; W3]^T [M, 2F] (Rp: R rounded up
// to 32).
extern "C" long long gaot_fused_ffn_scratch_bytes(int R, int M, int F, int dtype, int bwd) {
  const long long rf = (long long)R * F, packed = fused(M) ? 3LL * F * M * 2 : 0;
  if (dtype == 0) {
    const long long rp = rows_padded(R);
    return (bwd ? 2 * rf + (3LL * F + 2LL * M) * rp + 3LL * F * M : rf) * 4;
  }
  if (bwd) return 3 * rf * 2 + packed;
  return fused(M) ? packed : rf * 2;
}

// Row splits of the weight-gradient products: about two waves of blocks
// (one block an SM) over their tiles, each split at least 512 rows.
extern "C" int gaot_fused_ffn_bwd_splits(int R, int M, int F, int dtype, int sms) {
  if (dtype == 1 && !fused(M)) {
    // The general route walks the weight gradients' tiles and dx's in one
    // launch: splits that make a weight-gradient tile at most twice as long
    // as a dx tile (K = 2F) balance the blocks' shares.
    const long long w = (R + 63) / 64, d = 2LL * F / 64;
    const long long splits = (w + 2 * d - 1) / (2 * d), most = (R + 511) / 512;
    return (int)(splits < 1 ? 1 : splits > most ? (most < 1 ? 1 : most) : splits);
  }
  int tiles;
  if (dtype == 0) {
    tiles = 3 * (F / f32::TR) * (M / f32::TR);
  } else {
    const int bn = M % 256 == 0 ? 256 : 128;
    tiles = 3 * (F / GT) * (M / bn);
  }
  const int splits = (2 * sms + tiles / 2) / tiles;
  const int most = (R + 511) / 512;
  return splits < 1 ? 1 : splits > most ? (most < 1 ? 1 : most) : splits;
}

// x [R, M], w1 and w3 [F, M], w2 [M, F], out [R, M], all contiguous of
// dtype (0 fp32, 1 bf16); scratch as gaot_fused_ffn_scratch_bytes says.
// M and F multiples of 128 (the JAX gate).
extern "C" int gaot_fused_ffn_fwd(const void* x, const void* w1, const void* w3,
                                  const void* w2, void* out, void* scratch, int R,
                                  int M, int F, int dtype, void* stream) {
  if (R <= 0 || M <= 0 || F <= 0 || M % 128 || F % 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1),
               *w3b = static_cast<const bf16*>(w3), *w2b = static_cast<const bf16*>(w2);
    bf16* ob = static_cast<bf16*>(out);
    unsigned char* packed = static_cast<unsigned char*>(scratch);
    if (M == 128) return (int)fwd_fused<Fwd128>(xb, w1b, w3b, w2b, packed, ob, R, F, s);
    if (M == 256) return (int)fwd_fused<Fwd256>(xb, w1b, w3b, w2b, packed, ob, R, F, s);
    bf16* z = static_cast<bf16*>(scratch);
    return (int)ws::forward(xb, w1b, w3b, w2b, z, ob, R, M, F, s);
  }
  const float *xf = static_cast<const float*>(x), *w1f = static_cast<const float*>(w1),
              *w3f = static_cast<const float*>(w3), *w2f = static_cast<const float*>(w2);
  float* z = static_cast<float*>(scratch);
  RETURN_IF(tf32_produce<0>(xf, nullptr, w1f, w3f, nullptr, z, nullptr, nullptr, nullptr, R, R,
                            M, F, s));
  // out = z W2^T: W2 [M, F] is the K-major B.
  f32::Prod p{z, F, w2f, F, static_cast<float*>(out), M, 0, R, M, F, 0, 1};
  return (int)tf32_gemm(&p, 1, s);
}

// dout and dx [R, M]; part: [splits][3 F M] fp32 scratch; dw: [3 F M] fp32
// out (dW1 [F, M], dW3 [F, M], dW2 [M, F] back to back).
extern "C" int gaot_fused_ffn_bwd(const void* x, const void* w1, const void* w3,
                                  const void* w2, const void* dout,
                                  void* dx, void* scratch, void* part, void* dw,
                                  int R, int M, int F, int splits, int dtype,
                                  void* stream) {
  if (R <= 0 || M <= 0 || F <= 0 || M % 128 || F % 128 || splits <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long fm = (long long)F * M;
  float* pf = static_cast<float*>(part);
  if (dtype == 1) {
    const bf16 *xb = static_cast<const bf16*>(x), *db = static_cast<const bf16*>(dout);
    bf16* dh = static_cast<bf16*>(scratch);          // [R, 2F]
    bf16* z = dh + (long long)R * 2 * F;             // [R, F]
    const bf16 *w1b = static_cast<const bf16*>(w1), *w3b = static_cast<const bf16*>(w3),
               *w2b = static_cast<const bf16*>(w2);
    bf16* dxb = static_cast<bf16*>(dx);
    unsigned char* packed = reinterpret_cast<unsigned char*>(z + (long long)R * F);
    if (!fused(M)) {
      RETURN_IF(ws::backward(xb, db, w1b, w3b, w2b, dh, z, dxb, pf, R, M, F, splits, s));
    } else {
      RETURN_IF(M == 128
                    ? bwd_rows<Bwd128>(xb, db, w1b, w3b, w2b, packed, dxb, dh, z, R, F, s)
                    : bwd_rows<Bwd256>(xb, db, w1b, w3b, w2b, packed, dxb, dh, z, R, F, s));
      // dW1|dW3 = [dh1 dh3]^T x and dW2 = dout^T z, in one launch.
      RETURN_IF(wgrad_gemm({dh, 2LL * F, xb, M, pf, M, 3 * fm, 2 * F, M, R, 0},
                           {db, M, z, F, pf + 2 * fm, F, 3 * fm, M, F, R, 0}, splits, s));
    }
  } else {
    const float *xf = static_cast<const float*>(x), *df = static_cast<const float*>(dout);
    const float *w1f = static_cast<const float*>(w1), *w3f = static_cast<const float*>(w3),
                *w2f = static_cast<const float*>(w2);
    const long long rp = rows_padded(R);
    float* dh = static_cast<float*>(scratch);        // [R, 2F]: dh1 | dh3
    float* dht = dh + (long long)R * 2 * F;           // [2F, Rp]
    float* zt = dht + 2LL * F * rp;                   // [F, Rp]
    float* xt = zt + (long long)F * rp;               // [M, Rp]
    float* dt = xt + (long long)M * rp;               // [M, Rp]
    float* w2t = dt + (long long)M * rp;              // [F, M]
    float* w13t = w2t + fm;                           // [M, 2F]
    // The operands the products read transposed, K-major: W2^T for dz,
    // [W1; W3]^T for dx, x^T and dout^T for the weight gradients.
    const f32::TJob jobs[5] = {{w2f, w2t, F, M, M, M, F},
                               {w1f, w13t, M, 2LL * F, F, F, M},
                               {w3f, w13t + F, M, 2LL * F, F, F, M},
                               {xf, xt, M, rp, R, (int)rp, M},
                               {df, dt, M, rp, R, (int)rp, M}};
    RETURN_IF(tf32_transpose(jobs, 5, s));
    RETURN_IF(tf32_produce<1>(xf, df, w1f, w3f, w2t, nullptr, dh, dht, zt, R, (int)rp, M, F,
                              s));
    // dW1|dW3 = [dh1 dh3]^T x and dW2 = dout^T z (row-split partials), and
    // dx = [dh1 dh3] [W1; W3], in one launch.
    f32::Prod p[3] = {{dht, rp, xt, rp, pf, M, 3 * fm, 2 * F, M, R, 0, splits},
                      {dt, rp, zt, rp, pf + 2 * fm, F, 3 * fm, M, F, R, 0, splits},
                      {dh, 2LL * F, w13t, 2LL * F, static_cast<float*>(dx), M, 0, R, M, 2 * F,
                       0, 1}};
    RETURN_IF(tf32_gemm(p, 3, s));
  }
  const long long n = 3 * fm;
  ffn_bwd_reduce<<<grid_1d(n), 256, 0, s>>>(pf, static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}

// Grouped-query attention forward for Hopper (sm_90a):
//   out = softmax(Q K^T / sqrt(D)) V,  kv-head = head / (H / Hkv),
// with an optional base-2 row log-sum-exp m + log2(l) [B, H, S] for the
// backward (flash_attention_bwd.cu). Replaces the TPU kernels _attn_kernel
// and _attn_kernel_lse of gaot_tpu/ops/pallas/flash_attention.py
// (_flash_forward). Every kernel is a template on the head dim D, built for
// every multiple of 8 from 8 to 128.
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
// fp32 (flash_fwd_f32): one thread per query row on the CUDA cores, looping
// over D; tiles of 64 keys (32 above D = 64), an online softmax over chunks
// of 8 keys.
// Plain C interface; each entry returns cudaGetLastError() after its launch.
#include "flash_common.cuh"

namespace {

using namespace flash;

// ---- wgmma with A from registers: d[64 x N] (+)= a[64 x 16] . B[16 x N],
// B in shared memory by descriptor; TB = 1 reads B MN-major (transposed).
template <int N, int TB>
struct Wgmma;

template <int TB>
struct Wgmma<8, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB>
struct Wgmma<16, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB>
struct Wgmma<32, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB>
struct Wgmma<64, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

template <int TB>
struct Wgmma<128, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t a[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
          "n"(TB));
  }
};

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K) and stride byte offset (between
// core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup still run.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from reading an accumulator before wg_wait, and from
// reusing the registers of an A operand still in flight.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async one.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int S, int H, int Hkv, Strides qs,
              Strides ks, Strides vs, float scale_log2) {
  constexpr int KT = D > 64 ? 32 : BK;   // keys per tile: static shared memory
  __shared__ __align__(16) float Ks[KT][D];
  __shared__ __align__(16) float Vs[KT][D];

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

    // Online softmax over chunks of 8 keys: the chunk loop stays rolled, so
    // the code does not grow with the tile.
    const int kn = min(KT, S - kt);
#pragma unroll 1
    for (int j0 = 0; j0 < kn; j0 += 8) {
      float s[8];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j0 + jj][d], dot);
        s[jj] = j0 + jj < kn ? dot * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[jj]);
      }
      const float mn = fmaxf(m, mx);
      const float alpha = exp2f(m - mn);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[jj] = exp2f(s[jj] - mn);
        sum += s[jj];
      }
      l = l * alpha + sum;
      m = mn;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] = fmaf(s[jj], Vs[j0 + jj][d], o[d]);
    }
  }
  if (valid) {
    float* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = o[d] / l;
    if (lse != nullptr) lse[(long long)bh * S + row] = m + log2f(l);
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
      const dim3 grid(B * H, (S + BQ - 1) / BQ);
      flash_fwd_f32<D><<<grid, BQ, 0, st>>>(
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
  return dispatch_head_dim<LaunchFwd>(D, q, k, v, out, static_cast<float*>(lse),
                                      B, S, H, Hkv, qs, ks, vs, scale_log2, dtype,
                                      static_cast<cudaStream_t>(stream));
}

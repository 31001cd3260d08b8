// AGNO multiply-reduce for Hopper (sm_90a), reading the neighbour rows by
// index, forward / d_f and coefficient gradient:
//   gaot_mulred_k: out[row_map[q], b C + c]
//                    = sum_{k < K, mask[q, k]} coef(q, k)[c] * src[idx[q, k], b C + c],
//   gaot_mulred_b: d_coef(q, k)[c] = sum_b src[idx[q, k], b C + c] * dout[q, b C + c],
// with W = b * C. They replace the TPU kernels multiply_reduce_k and
// multiply_reduce_b of gaot_tpu/ops/pallas/multiply_reduce.py, and the row
// gathers (an index_select each) that fed them: the TPU kernels reduce a
// [K, Q, W] tensor of rows gathered beforehand, these read each neighbour
// row where it lies. The coefficient of slot (q, k) is either given per
// edge, coef + q cs_q + k cs_k (the forward's [Q, K, C]), or gathered by a
// second index, coef + cidx[q, k] C (d_f's coef_flat[edge_pos[n, j]]).
// With no idx, row k Q + q of src is read: the TPU kernels' own contract,
// a pre-gathered gath [K, Q, W], is the index-free instance of the same
// kernels.
//
// Both are bound by memory: 2 flops per element of a row read. A random
// row is 32-128 bytes on the 3D paths (W = 16 or 64 bf16), so the rate of
// row loads in flight, not the bytes, sets the time. The design:
//   - blocks shaped by the lane width: a row takes tc threads of 16-byte
//     vectors (2 at W = 16 bf16, 8 at W = 64) times its slices (below),
//     a block holds 256 threads' worth of rows; past 256 vectors a row (the
//     fx path's W = 4096) a block is one row times a chunk of 256 vectors;
//   - many row loads in flight: a thread keeps 32 registers, so an SM
//     holds 2048 threads, each with its row and coefficient loads in
//     flight (unrolling the slots instead, with fewer threads, ran
//     slower); where a row has 16 slots or more and few threads, its
//     slots are split into slices (k mod ks) over more threads, whose
//     partial sums fold in a fixed order by warp shuffles;
//   - the valid slots come from the mask 32 at a time, as bits, so a
//     masked slot costs a bit and issues no load of its index, row or
//     coefficient (a transpose graph's padding, 60% of the flagship
//     encoder's [32768, 160] slots), no index of a masked slot is read or
//     clamped, and a row with no valid slot writes zeros;
//   - the coefficients and indices are read once, streamed with the
//     evict-first hint (ld.global.cs), so the source rows stay in L2;
//   - deterministic: k order within a slice, then a fixed fold; fp32
//     registers, no atomics.
// mulred_b keeps its lane-width design (further below); only its row load
// goes through idx. Plain C interface; each entry returns cudaGetLastError()
// after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerSlice = 8;     // mulred_k splits a row's slots from 16 on

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A source row's vector: cached (read-only path), as rows repeat across
// queries.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_row(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = __ldg(p + j);
  }
  return r;
}

// A coefficient vector, read once: streamed (evict first).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_stream(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    *reinterpret_cast<uint4*>(&r) = __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = __ldcs(p + j);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* acc) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = from_f<T>(acc[j]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = o;
}

// The valid slots k0 .. k0 + kn - 1 (kn <= 32) of one query row as bits:
// bit u is slot k0 + u. With no mask every slot is valid. A torch bool is
// one byte of 0 or 1; where the mask row is 4-byte aligned, four bytes load
// at once and (x * 0x01020408) >> 24 packs them into four bits.
__device__ __forceinline__ unsigned slot_bits(const uint8_t* __restrict__ m, int kn,
                                              bool words) {
  if (m == nullptr) return kn == 32 ? 0xffffffffu : (1u << kn) - 1;
  unsigned bits = 0;
  if (words) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (4 * i < kn) {
        const unsigned x = __ldcs(reinterpret_cast<const unsigned*>(m) + i);
        bits |= (((x * 0x01020408u) >> 24) & 0xfu) << (4 * i);
      }
    return kn == 32 ? bits : bits & ((1u << kn) - 1);
  }
#pragma unroll 8
  for (int i = 0; i < kn; ++i) bits |= (unsigned)(__ldcs(m + i) != 0) << i;
  return bits;
}

// One thread: the VEC lanes w0.. of query row q, and one slice of its
// slots (those at k = slice mod ks). The valid slots of the slice are found
// from the mask 32 at a time (one round of loads), then read one at a time
// (its indices, then its row and coefficient) and summed in k order; the ks
// slices of a row then fold in a fixed order by warp shuffles. Loads in
// flight come from threads, not from unrolling: at 32 registers a thread
// the SM holds 2048 of them.
template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
mulred_k_kernel(const T* __restrict__ src, const I* __restrict__ idx,
                const T* __restrict__ coef, const I* __restrict__ cidx,
                const uint8_t* __restrict__ mask, const I* __restrict__ row_map,
                T* __restrict__ out, int K, int Q, int C, int W,
                long long cs_q, long long cs_k, int tc, int ks, int rows) {
  const int tr = tc * ks;
  const int r = threadIdx.x / tr, lane = threadIdx.x % tr;
  const int slice = lane / tc;
  const int q = blockIdx.x * rows + r;
  const int w0 = (blockIdx.y * tc + lane % tc) * VEC;
  const bool active = r < rows && q < Q && w0 < W;
  const int c0 = w0 % C;
  const long long qk = (long long)q * K;
  const bool words = mask != nullptr && (K & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  unsigned mine = 0;                                  // this slice's bit positions
  for (int p = slice; p < 32; p += ks) mine |= 1u << p;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int k0 = 0; active && k0 < K; k0 += 32) {
    unsigned bits = slot_bits(mask ? mask + qk + k0 : nullptr, min(32, K - k0), words) & mine;
    while (bits) {
      const int k = k0 + __ffs(bits) - 1;
      bits &= bits - 1;
      const long long srow = idx ? (long long)__ldcs(idx + qk + k) : (long long)k * Q + q;
      const long long co = cidx ? (long long)__ldcs(cidx + qk + k) * C : q * cs_q + k * cs_k;
      const Pack<T, VEC> x = load_row<T, VEC>(src + srow * W + w0);
      const Pack<T, VEC> cf = load_stream<T, VEC>(coef + co + c0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f(x.v[j]) * to_f(cf.v[j]);
    }
  }
  // A row's tr = tc * ks threads are adjacent lanes of one warp (tr is a
  // power of two when ks > 1); slice s adds slice s + off / tc, halving.
  for (int off = tr / 2; off >= tc && ks > 1; off /= 2) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  }
  if (!active || slice != 0) return;
  const long long orow = row_map ? (long long)__ldcs(row_map + q) : q;
  store<T, VEC>(out + orow * W + w0, acc);
}

template <typename T, int VEC, typename I>
cudaError_t launch_k(const void* src, const void* idx, const void* coef,
                     const void* cidx, const void* mask, const void* row_map,
                     void* out, int K, int Q, int C, int W, long long cs_q,
                     long long cs_k, cudaStream_t stream) {
  const int nv = W / VEC;
  const int tc = nv < kThreads ? nv : kThreads;
  // Slices of the slots where a row's threads are a power of two below a
  // warp: each slice takes kSlotsPerSlice slots or more (at K = 160: 16
  // slices at W = 16 bf16, 4 at W = 64; none at K = 8).
  int ks = 1;
  if ((tc & (tc - 1)) == 0)
    while (2 * ks * tc <= 32 && 2 * ks * kSlotsPerSlice <= K) ks *= 2;
  const int rows = kThreads / (tc * ks);
  dim3 grid((Q + rows - 1) / rows, (nv + tc - 1) / tc);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  mulred_k_kernel<T, VEC, I><<<grid, rows * tc * ks, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const I*>(idx),
      static_cast<const T*>(coef), static_cast<const I*>(cidx),
      static_cast<const uint8_t*>(mask), static_cast<const I*>(row_map),
      static_cast<T*>(out), K, Q, C, W, cs_q, cs_k, tc, ks, rows);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// d_coef(q, k)[c] = sum_b src[idx[q, k], b * C + c] * dout[q, b * C + c],
// written at out + q os_q + k os_k + c. Narrow lanes (W = b C of 16 or 64
// at the 3D paths) gave a design of one block per query row two or eight
// threads wide, so the design is per lane width: a row takes tr = tc * ns
// threads (tc channel vectors of VEC elements, ns slices of b), a block
// holds rows = 256 / tr contiguous query rows of one k, and k is the
// fastest grid index, so every block has 256 threads and the blocks of one
// query range, which share its dout rows, run side by side. A thread reads
// its row's index once, then sums its slice of b (b = slice, slice + ns,
// ...) for its channel vector in fp32 registers with 16-byte loads of the
// source row and dout. ns = ceil(b / kBPerThread): at b <= 8 ns = 1 and the
// thread writes its VEC outputs straight from registers, with no shared
// memory and no barrier; otherwise the ns slices are folded in a fixed
// order through shared memory, so the result is deterministic with no
// atomics.
constexpr int kBPerThread = 8;

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads)
mulred_b_kernel(const T* __restrict__ src, const I* __restrict__ idx,
                const T* __restrict__ dout, T* __restrict__ out, int K, int Q,
                int C, int W, long long os_q, long long os_k, int tc, int ns,
                int rows) {
  extern __shared__ float red[];                      // [rows][ns][C]
  const int k = blockIdx.x % K;
  const int q0 = (blockIdx.x / K) * rows;
  const int tr = tc * ns;
  const int r = threadIdx.x / tr, lane = threadIdx.x % tr;
  const int cv0 = lane % tc, slice = lane / tc;
  const int ncv = C / VEC, nb = W / C;
  const int q = q0 + r;
  const bool active = r < rows && q < Q;
  long long srow = 0;
  if (active) srow = idx ? (long long)__ldcs(idx + (long long)q * K + k) : (long long)k * Q + q;
  const T* drow = dout + (long long)q * W;
  const T* grow = src + srow * W;

  for (int cv = cv0; active && cv < ncv; cv += tc) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int bb = slice; bb < nb; bb += ns) {
      const int w = bb * C + cv * VEC;
      const Pack<T, VEC> d = *reinterpret_cast<const Pack<T, VEC>*>(drow + w);
      const Pack<T, VEC> g = load_row<T, VEC>(grow + w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f(g.v[j]) * to_f(d.v[j]);
    }
    if (ns == 1) {
      store<T, VEC>(out + q * os_q + k * os_k + cv * VEC, acc);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(r * ns + slice) * C + cv * VEC + j] = acc[j];
    }
  }
  if (ns == 1) return;
  __syncthreads();
  const int nrow = min(rows, Q - q0);
  for (int i = threadIdx.x; i < nrow * C; i += blockDim.x) {
    const int rr = i / C, c = i % C;
    float s = 0.f;
    for (int sl = 0; sl < ns; ++sl) s += red[(rr * ns + sl) * C + c];
    out[(q0 + rr) * os_q + k * os_k + c] = from_f<T>(s);
  }
}

template <typename T, int VEC, typename I>
cudaError_t launch_b(const void* src, const void* idx, const void* dout,
                     void* out, int K, int Q, int C, int W, long long os_q,
                     long long os_k, cudaStream_t stream) {
  const int ncv = C / VEC, nb = W / C;
  const int tc = ncv < kThreads ? ncv : kThreads;
  int ns = (nb + kBPerThread - 1) / kBPerThread;
  if (ns > kThreads / tc) ns = kThreads / tc;
  const int rows = kThreads / (tc * ns);
  const size_t smem = ns > 1 ? sizeof(float) * (size_t)rows * ns * C : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (long long)((Q + rows - 1) / rows) * K;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mulred_b_kernel<T, VEC, I><<<(unsigned)blocks, rows * tc * ns, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const I*>(idx),
      static_cast<const T*>(dout), static_cast<T*>(out), K, Q, C, W, os_q,
      os_k, tc, ns, rows);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_k_index(int index_bits, const void* src, const void* idx,
                           const void* coef, const void* cidx, const void* mask,
                           const void* row_map, void* out, int K, int Q, int C,
                           int W, long long cs_q, long long cs_k, cudaStream_t s) {
  if (index_bits == 32)
    return launch_k<T, VEC, int32_t>(src, idx, coef, cidx, mask, row_map, out,
                                     K, Q, C, W, cs_q, cs_k, s);
  if (index_bits == 64)
    return launch_k<T, VEC, long long>(src, idx, coef, cidx, mask, row_map, out,
                                       K, Q, C, W, cs_q, cs_k, s);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t launch_b_index(int index_bits, const void* src, const void* idx,
                           const void* dout, void* out, int K, int Q, int C,
                           int W, long long os_q, long long os_k, cudaStream_t s) {
  if (index_bits == 32)
    return launch_b<T, VEC, int32_t>(src, idx, dout, out, K, Q, C, W, os_q, os_k, s);
  if (index_bits == 64)
    return launch_b<T, VEC, long long>(src, idx, dout, out, K, Q, C, W, os_q, os_k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// src [*, W] rows; idx [Q, K] (or null: row k Q + q); coef per edge at
// coef + q cs_q + k cs_k (cidx null) or rows of a [*, C] table at
// coef + cidx[q, k] C; mask [Q, K] bytes or null (every slot); row_map [Q]
// or null (row q); out [*, W]. idx, cidx and row_map are index_bits wide.
extern "C" int gaot_mulred_k(const void* src, const void* idx, const void* coef,
                             const void* cidx, const void* mask,
                             const void* row_map, void* out, int K, int Q, int C,
                             int W, long long cs_q, long long cs_k,
                             int index_bits, int dtype, void* stream) {
  if (K < 0 || Q <= 0 || W <= 0 || C <= 0 || W % C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(src) && aligned16(coef) && aligned16(out);
  const long long vec = dtype == 1 ? 8 : 4;
  const bool vec_ok = aligned && C % vec == 0 &&
                      (cidx != nullptr || (cs_q % vec == 0 && cs_k % vec == 0));
  if (dtype == 1) {
    if (vec_ok)
      return (int)launch_k_index<__nv_bfloat16, 8>(index_bits, src, idx, coef, cidx,
                                                   mask, row_map, out, K, Q, C, W,
                                                   cs_q, cs_k, s);
    return (int)launch_k_index<__nv_bfloat16, 1>(index_bits, src, idx, coef, cidx,
                                                 mask, row_map, out, K, Q, C, W,
                                                 cs_q, cs_k, s);
  }
  if (dtype == 0) {
    if (vec_ok)
      return (int)launch_k_index<float, 4>(index_bits, src, idx, coef, cidx, mask,
                                           row_map, out, K, Q, C, W, cs_q, cs_k, s);
    return (int)launch_k_index<float, 1>(index_bits, src, idx, coef, cidx, mask,
                                         row_map, out, K, Q, C, W, cs_q, cs_k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// src [*, W] rows; idx [Q, K] (or null: row k Q + q); dout [Q, W];
// out(q, k) at out + q os_q + k os_k, C contiguous.
extern "C" int gaot_mulred_b(const void* src, const void* idx, const void* dout,
                             void* out, int K, int Q, int C, int W,
                             long long os_q, long long os_k, int index_bits,
                             int dtype, void* stream) {
  if (K <= 0 || Q <= 0 || C <= 0 || W <= 0 || W % C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vec = dtype == 1 ? 8 : 4;
  const bool vec_ok = aligned16(src) && aligned16(dout) && aligned16(out) &&
                      C % vec == 0 && os_q % vec == 0 && os_k % vec == 0;
  if (dtype == 1) {
    if (vec_ok)
      return (int)launch_b_index<__nv_bfloat16, 8>(index_bits, src, idx, dout, out,
                                                   K, Q, C, W, os_q, os_k, s);
    return (int)launch_b_index<__nv_bfloat16, 1>(index_bits, src, idx, dout, out,
                                                 K, Q, C, W, os_q, os_k, s);
  }
  if (dtype == 0) {
    if (vec_ok)
      return (int)launch_b_index<float, 4>(index_bits, src, idx, dout, out, K, Q,
                                           C, W, os_q, os_k, s);
    return (int)launch_b_index<float, 1>(index_bits, src, idx, dout, out, K, Q, C,
                                         W, os_q, os_k, s);
  }
  return (int)cudaErrorInvalidValue;
}

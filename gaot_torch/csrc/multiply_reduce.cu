// AGNO multiply-reduce for Hopper (sm_90a), forward and coefficient gradient:
//   gaot_mulred_k: out[q, w] = sum_k coef[k, q, w mod C] * gath[k, q, w],
//   gaot_mulred_b: d_coef[k, q, c] = sum_b gath[k, q, b C + c] * dout[q, b C + c],
// with W = b * C. They replace the TPU kernels multiply_reduce_k and
// multiply_reduce_b of gaot_tpu/ops/pallas/multiply_reduce.py. Both are
// bound by device memory: every element of gath [K, Q, W] is read once, with
// 16-byte vector loads, for 2 flops, and summed in fp32 registers. The coef
// rows of a mulred_k block are staged in shared memory in chunks of k.
// mulred_b sizes its blocks by the lane width W (further below), where the
// TPU kernel folds adjacent queries into one 128-lane row for the same
// reason: narrow rows alone leave the machine idle.
// Plain C interface; each entry returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneThreads = 64;         // threads along W per block
constexpr int kRows = 4;                 // query rows per block
constexpr int kSmemFloats = 12288;       // 48 KB of staged coef

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kLaneThreads * kRows)
mulred_k_kernel(const T* __restrict__ gath, const T* __restrict__ coef,
                T* __restrict__ out, int K, int Q, int C, int W,
                long long cs_k, long long cs_q, int rows, int kc) {
  extern __shared__ float sc[];                       // [kc][rows][C]
  const int q0 = blockIdx.x * rows;
  const int q = q0 + threadIdx.y;
  const int w0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const bool active = q < Q && w0 < W;
  const int c0 = w0 % C;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const long long plane = (long long)Q * W;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    __syncthreads();
    for (int i = tid; i < kn * rows * C; i += nthr) {
      const int c = i % C;
      const int r = (i / C) % rows;
      const int kk = i / (C * rows);
      const int qq = q0 + r;
      sc[i] = qq < Q ? to_f(coef[(k0 + kk) * cs_k + qq * cs_q + c]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const T* g = gath + (long long)k0 * plane + (long long)q * W + w0;
      const float* s = sc + threadIdx.y * C + c0;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const Pack<T, VEC> p =
            *reinterpret_cast<const Pack<T, VEC>*>(g + kk * plane);
        const float* sk = s + kk * rows * C;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += to_f(p.v[j]) * sk[j];
      }
    }
  }
  if (active) {
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f<T>(acc[j]);
    *reinterpret_cast<Pack<T, VEC>*>(out + (long long)q * W + w0) = o;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* gath, const void* coef, void* out, int K,
                   int Q, int C, int W, long long cs_k, long long cs_q,
                   cudaStream_t stream) {
  int rows = kRows;
  int kc = K < 1 ? 1 : K;
  if (kc * rows * C > kSmemFloats) kc = kSmemFloats / (rows * C);
  if (kc < 1) {
    rows = 1;
    kc = kSmemFloats / C;
  }
  if (kc < 1) return cudaErrorInvalidValue;   // C > 12288 channels
  const int vecs = (W + VEC - 1) / VEC;
  dim3 block(kLaneThreads, rows);
  dim3 grid((Q + rows - 1) / rows, (vecs + kLaneThreads - 1) / kLaneThreads);
  const size_t smem = sizeof(float) * (size_t)kc * rows * C;
  mulred_k_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(gath), static_cast<const T*>(coef),
      static_cast<T*>(out), K, Q, C, W, cs_k, cs_q, rows, kc);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// d_coef[k, q, c] = sum_b gath[k, q, b * C + c] * dout[q, b * C + c].
// Narrow lanes (W = b C of 16 or 64 at the 3D paths) gave a design of one
// block per query row two or eight threads wide, so the design is per lane
// width: a row takes tr = tc * ns threads (tc channel vectors of VEC
// elements, ns slices of b), a block holds rows = 256 / tr contiguous query
// rows of one k, and k is the fastest grid index, so every block has 256
// threads and the blocks of one query range, which share its dout rows, run
// side by side. A thread sums its slice of b (b = slice, slice + ns, ...)
// for its channel vector in fp32 registers with 16-byte loads of gath and
// dout. ns = ceil(b / kBPerThread): at b <= 8 ns = 1 and the thread writes
// its VEC outputs straight from registers, with no shared memory and no
// barrier; otherwise the ns slices are folded in a fixed order through
// shared memory, so the result is deterministic with no atomics.
constexpr int kBThreads = 256;
constexpr int kBPerThread = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kBThreads)
mulred_b_kernel(const T* __restrict__ gath, const T* __restrict__ dout,
                T* __restrict__ out, int K, int Q, int C, int W, int tc,
                int ns, int rows) {
  extern __shared__ float red[];                      // [rows][ns][C]
  const int k = blockIdx.x % K;
  const int q0 = (blockIdx.x / K) * rows;
  const int tr = tc * ns;
  const int r = threadIdx.x / tr, lane = threadIdx.x % tr;
  const int cv0 = lane % tc, slice = lane / tc;
  const int ncv = C / VEC, nb = W / C;
  const int q = q0 + r;
  const bool active = r < rows && q < Q;
  const T* drow = dout + (long long)q * W;
  const T* grow = gath + ((long long)k * Q + q) * W;

  for (int cv = cv0; active && cv < ncv; cv += tc) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int bb = slice; bb < nb; bb += ns) {
      const int w = bb * C + cv * VEC;
      const Pack<T, VEC> d = *reinterpret_cast<const Pack<T, VEC>*>(drow + w);
      const Pack<T, VEC> g = *reinterpret_cast<const Pack<T, VEC>*>(grow + w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f(g.v[j]) * to_f(d.v[j]);
    }
    if (ns == 1) {
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = from_f<T>(acc[j]);
      *reinterpret_cast<Pack<T, VEC>*>(out + ((long long)k * Q + q) * C + cv * VEC) = o;
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
    out[((long long)k * Q + q0 + rr) * C + c] = from_f<T>(s);
  }
}

template <typename T, int VEC>
cudaError_t launch_b(const void* gath, const void* dout, void* out, int K,
                     int Q, int C, int W, cudaStream_t stream) {
  const int ncv = C / VEC, nb = W / C;
  const int tc = ncv < kBThreads ? ncv : kBThreads;
  int ns = (nb + kBPerThread - 1) / kBPerThread;
  if (ns > kBThreads / tc) ns = kBThreads / tc;
  const int rows = kBThreads / (tc * ns);
  const size_t smem = ns > 1 ? sizeof(float) * (size_t)rows * ns * C : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (long long)((Q + rows - 1) / rows) * K;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mulred_b_kernel<T, VEC><<<(unsigned)blocks, rows * tc * ns, smem, stream>>>(
      static_cast<const T*>(gath), static_cast<const T*>(dout),
      static_cast<T*>(out), K, Q, C, W, tc, ns, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gaot_mulred_b(const void* gath, const void* dout, void* out,
                             int K, int Q, int C, int W, int dtype,
                             void* stream) {
  if (K <= 0 || Q <= 0 || C <= 0 || W <= 0 || W % C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(gath) && aligned16(dout) && aligned16(out);
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0)
      return (int)launch_b<__nv_bfloat16, 8>(gath, dout, out, K, Q, C, W, s);
    return (int)launch_b<__nv_bfloat16, 1>(gath, dout, out, K, Q, C, W, s);
  }
  if (dtype == 0) {
    if (vec_ok && C % 4 == 0)
      return (int)launch_b<float, 4>(gath, dout, out, K, Q, C, W, s);
    return (int)launch_b<float, 1>(gath, dout, out, K, Q, C, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gaot_mulred_k(const void* gath, const void* coef, void* out,
                             int K, int Q, int C, int W, long long cs_k,
                             long long cs_q, int dtype, void* stream) {
  if (Q <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(gath) && aligned16(out);
  cudaError_t err;
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0 && W % 8 == 0)
      err = launch<__nv_bfloat16, 8>(gath, coef, out, K, Q, C, W, cs_k, cs_q, s);
    else
      err = launch<__nv_bfloat16, 1>(gath, coef, out, K, Q, C, W, cs_k, cs_q, s);
  } else if (dtype == 0) {
    if (vec_ok && C % 4 == 0 && W % 4 == 0)
      err = launch<float, 4>(gath, coef, out, K, Q, C, W, cs_k, cs_q, s);
    else
      err = launch<float, 1>(gath, coef, out, K, Q, C, W, cs_k, cs_q, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// AGNO multiply-reduce for Hopper (sm_90a):
//   out[q, w] = sum_k coef[k, q, w mod C] * gath[k, q, w],   W = b * C.
// Memory-bound: every element of gath [K, Q, W] is read once, with 16-byte
// vector loads, and summed down k in fp32 registers. The coef rows of the
// block's queries are staged in shared memory in chunks of k.
// Plain C interface; returns cudaGetLastError() after the launch.
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

}  // namespace

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

// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) and the bf16 route for head dims above
// 128 (flash_wide.cu): the head-dim limits, the strides of q, k and v, the
// register A fragments of the forward's Q and of accumulators, and the
// tiles of the fp32 route for head dims above 128.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int MAX_D = 128;   // the largest head dim of the templated kernels

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The accumulator of a 64 x N product, rounded to bf16, as the register A
// fragments of the N / 16 k-steps of a product that contracts over its N.
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (*a)[4], const float* acc) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// A fragment (16 rows x 16 of D) of k-step st, rows r0 and r0 + 8 at p0 and
// p1 (read only where ok0 / ok1); columns at or past D are zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* p0,
                                       const bf16* p1, bool ok0, bool ok1,
                                       int st, int t) {
  const int c = st * 16 + 2 * t;
  const bool lo = st * 16 < D, hi = st * 16 + 8 < D;
  a[0] = ok0 && lo ? ld32(p0 + c) : 0u;
  a[1] = ok1 && lo ? ld32(p1 + c) : 0u;
  a[2] = ok0 && hi ? ld32(p0 + c + 8) : 0u;
  a[3] = ok1 && hi ? ld32(p1 + c + 8) : 0u;
}

// ---- Head dims above 128 (any multiple of 8), D at run time, fp32: the
// wide route of flash_attention.cu (flash_fwd_wide) and
// flash_attention_bwd.cu (flash_bwd_*_wide), on the CUDA cores (fp32
// products stay fp32: no TF32). bf16 takes flash_wide.cu, every product on
// wgmma. A block owns WR rows (queries, or keys in dK/dV) and one slice of
// WO columns of its outputs' head dim (a grid dimension); it recomputes the
// full-D scores (and dP) by streaming both sides through shared memory in
// head-dim slices of WS. The arithmetic is the 8-128 kernels': fp32 scores
// and softmax, exp2, the base-2 LSE.
constexpr int WR = 64;        // rows of a block and of a streamed tile
constexpr int WS = 64;        // head-dim slice of the score products
constexpr int WO = 128;       // head-dim slice of a block's outputs
constexpr int WSP = WS + 1;   // padded rows of the shared tiles
constexpr int WOP = WO + 1;

// dst[r][c] (row stride ld) = row r0 + r of a [*, S, *, D] tensor (base at
// its head, row stride rs), columns c0 + c, for c < width; zero past S or D.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* base,
                                              long long rs, int r0, int S,
                                              int c0, int D, int width) {
  for (int i = threadIdx.x; i < WR * width; i += blockDim.x) {
    const int r = i / width, c = i % width;
    const bool ok = r0 + r < S && c0 + c < D;
    dst[r * ld + c] = ok ? base[(long long)(r0 + r) * rs + c0 + c] : 0.f;
  }
}

}  // namespace flash

// Calls F<D>::run(args...) for the runtime head dim d, a multiple of 8 from 8
// to 128; returns cudaErrorInvalidValue for any other d.
template <template <int> class F, typename... A>
int dispatch_head_dim(int d, A... args) {
  switch (d) {
    case 8: return F<8>::run(args...);
    case 16: return F<16>::run(args...);
    case 24: return F<24>::run(args...);
    case 32: return F<32>::run(args...);
    case 40: return F<40>::run(args...);
    case 48: return F<48>::run(args...);
    case 56: return F<56>::run(args...);
    case 64: return F<64>::run(args...);
    case 72: return F<72>::run(args...);
    case 80: return F<80>::run(args...);
    case 88: return F<88>::run(args...);
    case 96: return F<96>::run(args...);
    case 104: return F<104>::run(args...);
    case 112: return F<112>::run(args...);
    case 120: return F<120>::run(args...);
    case 128: return F<128>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

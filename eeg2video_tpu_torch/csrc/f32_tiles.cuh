// Shared pieces of the f32 kernels (flash_f32*.cu, ff_f32.cu, geglu_f32.cu).
//
// These are the f32 counterparts of the Pallas kernels that the JAX package
// also runs on f32 operands (its dispatch tests no dtype there): plain SIMT
// kernels, f32 loads, f32 FMA, f32 accumulation, expf / erff. A block of 256
// threads is a 16 x 16 grid (ty, tx); in a block product thread (ty, tx)
// owns rows RM ty .. RM ty + RM - 1 and columns tx + 16 j of the output, so
// the 16 threads of a row group sit in one half-warp and a row's reduction
// is four xor-shuffles in a fixed order. Operand tiles live in shared memory
// with odd row strides, so that both a row and a column walk hit distinct
// banks. What bounds them on the H100 is the FP32 rate without tensor cores
// (67 TFLOP/s) and the shared-memory loads that feed it; making them fast
// (3xTF32 on the tensor cores) is later work.
#pragma once

#include "common.cuh"

namespace e2v {
namespace f32k {

constexpr int kThreads = 256;

__device__ __forceinline__ int ty() { return threadIdx.x >> 4; }
__device__ __forceinline__ int tx() { return threadIdx.x & 15; }

// sum and max over the 16 threads of a row group (lane bits 0-3)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[i][j] += sum_k A(RM ty + i, k) B(k, tx + 16 j), k = 0 .. K - 1, with
// A(r, k) = A[r a_r + k a_k] and B(k, c) = B[k b_k + c b_c] in shared memory;
// the sum over k runs in order
template <int RM, int NJ, int K>
__device__ __forceinline__ void mm(float (&acc)[RM][NJ], const float* A, int a_r, int a_k,
                                   const float* B, int b_k, int b_c) {
  const float* a0 = A + ty() * RM * a_r;
  const float* b0 = B + tx() * b_c;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[NJ];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = a0[i * a_r + k * a_k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = b0[j * 16 * b_c + k * b_k];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int RM, int NJ>
__device__ __forceinline__ void zero(float (&acc)[RM][NJ]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
}

// s[r LD + c] = src[(r0 + r) sr + c0 + c] for r < R, c < CW, zero past
// nrows rows or ncols columns
template <int R, int CW, int LD>
__device__ __forceinline__ void load_tile(float* s, const float* src, long long sr, int r0,
                                          int nrows, int c0, int ncols) {
  for (int i = threadIdx.x; i < R * CW; i += kThreads) {
    const int r = i / CW, c = i % CW;
    float v = 0.0f;
    if (r0 + r < nrows && c0 + c < ncols) v = src[(long long)(r0 + r) * sr + c0 + c];
    s[r * LD + c] = v;
  }
}

}  // namespace f32k
}  // namespace e2v

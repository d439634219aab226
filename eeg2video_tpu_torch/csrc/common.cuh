// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel here is a first, simple version: bf16 WMMA tiles (16x16x16,
// f32 accumulation) staged through shared memory. wgmma, TMA and warp
// specialisation are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace e2v {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrtHalf = 0.70710678118654752f;

// 8 bf16 values moved as one 16-byte vector.
union Vec8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ Vec8 zero_vec8() {
  Vec8 v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  return v;
}

__device__ __forceinline__ Vec8 load_vec8(const bf16* p) {
  Vec8 v;
  v.u = *reinterpret_cast<const uint4*>(p);
  return v;
}

__device__ __forceinline__ void store_vec8(bf16* p, const Vec8& v) {
  *reinterpret_cast<uint4*>(p) = v.u;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact (erf) GELU, as jax.nn.gelu(approximate=False).
__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * kSqrtHalf));
}

__device__ __forceinline__ float silu(float f) { return f / (1.0f + expf(-f)); }

}  // namespace e2v

// Launch helper: raise the dynamic shared-memory cap, launch, and return the
// launch status (0 on success) for the ctypes wrapper to check.
#define E2V_LAUNCH(kernel, grid, block, smem, stream, ...)                      \
  do {                                                                          \
    cudaError_t e2v_err_ = cudaFuncSetAttribute(                                \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(smem));      \
    if (e2v_err_ != cudaSuccess) return (int)e2v_err_;                          \
    kernel<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__);   \
    return (int)cudaGetLastError();                                             \
  } while (0)

// Shared helpers for the port's Hopper kernels (sm_90a).
//
// The attention kernels (flash_fwd.cuh, flash_bwd.cuh) and the feed-forward
// kernels ff_ln and ff_ln_bwd (ff_ln.cu, ff_ln_bwd.cu) keep their
// accumulators in registers: mma.sync.m16n8k16 with f32 accumulators,
// operands by ldmatrix, tiles (for the feed-forward the weight slabs, through
// a three-stage ring: ff_tiles.cuh) streamed by cp.async (flash_tiles.cuh).
// The level-0 conv (conv3x3.cu) does the same on wgmma.mma_async: A by
// ldmatrix into registers, B (its weight slabs, a four-stage ring of bulk
// copies) from shared memory by descriptor; geglu_out (geglu_out.cu) reads
// both operands by descriptor, its gated A tile written by the block, W and
// h2 brought by TMA (the wgmma and copy helpers of both: hopper.cuh), and so
// does geglu_out_bwd (geglu_out_bwd.cu, W read MN-major). The temporal pair
// stages runs of its operands by bulk copies (temporal_attention.cuh, f32
// arithmetic without tensor cores, bf16 and f32 instantiations). One first
// version remains: int8_dense (bf16 WMMA tiles, 16x16x16 with f32
// accumulation, staged through shared memory). The f32 counterparts that f32
// operands launch run 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh): the
// attention pair (flash_f32*.cu), and the feed-forward pair (ff_f32.cu) and
// the GEGLU pair (geglu_f32.cu) on the GEMM tiles of tf32_gemm.cuh. Warp
// specialisation is later work.
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
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact (erf) GELU, as jax.nn.gelu(approximate=False).
__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * kSqrtHalf));
}

// (gelu_erf(g), d gelu_erf / dg): g Phi(g) and Phi(g) + g phi(g).
__device__ __forceinline__ void gelu_erf_grad(float g, float& gelu, float& dgelu) {
  const float Phi = 0.5f * (1.0f + erff(g * kSqrtHalf));
  gelu = g * Phi;
  dgelu = Phi + g * kInvSqrt2Pi * expf(-0.5f * g * g);
}

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

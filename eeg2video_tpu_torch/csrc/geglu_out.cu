// geglu_out: the GEGLU gate fused into the out-projection GEMM,
//   out = (h * gelu_erf(g)) W^T + b,   [h | g] = h2 (T, 2I).
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _geglu_kernel (:59), the
// feed-forward out-projection of the C = 1280 levels (level 2 and the mid
// block), where LN and the projection run as plain torch ops.
//
// What bounds it on the H100: a 2*T*I*C FLOP GEMM (T = 1728, I = 5120,
// C = 1280: 22.6 GFLOP) that reads the (T, 2I) bf16 input once (35 MB) and
// the (C, I) weight once per row tile: compute-bound at these shapes. The
// gated (T, I) tensor is never written: the gate is the GEMM's A-operand
// prologue.
// Design: 64x64 output tiles, 4 warps of 32x32 (2x2 WMMA fragments), a
// K-step of 32: each step loads the matching h and g slices of h2, computes
// h * gelu(g) in f32 and stores the bf16 product as the A tile in shared
// memory; the B tile is the weight slice. Bias added in f32 in the epilogue.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kLDA = kBK + 8;
constexpr int kLDC = kBN + 4;

__global__ void __launch_bounds__(kThreads)
    geglu_out_kernel(const bf16* __restrict__ h2, const bf16* __restrict__ w,
                     const float* __restrict__ b, bf16* __restrict__ out, int T, int I,
                     int C) {
  __shared__ __align__(128) bf16 As[kBM * kLDA];
  __shared__ __align__(128) bf16 Bs[kBN * kLDA];
  __shared__ __align__(128) float Cs[kBM * kLDC];

  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < I; k0 += kBK) {
    // 64 rows x 4 vectors of 8: two vectors per thread for A and for B
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int r = idx >> 2, kv = (idx & 3) * 8;
      const int row = row0 + r;
      Vec8 gated = zero_vec8();
      if (row < T) {
        const bf16* src = h2 + (long long)row * 2 * I + k0 + kv;
        const Vec8 hv = load_vec8(src);
        const Vec8 gv = load_vec8(src + I);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          gated.h[e] = __float2bfloat16(__bfloat162float(hv.h[e]) *
                                        gelu_erf(__bfloat162float(gv.h[e])));
      }
      store_vec8(As + r * kLDA + kv, gated);
      const int col = col0 + r;
      Vec8 wv = zero_vec8();
      if (col < C) wv = load_vec8(w + (long long)col * I + k0 + kv);
      store_vec8(Bs + r * kLDA + kv, wv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragA fa[2];
      FragBCol fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * kLDA + kk * 16, kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wc * 32 + j * 16) * kLDA + kk * 16, kLDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kLDC + wc * 32 + j * 16, acc[i][j],
                              kLDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, c = e % kBN;
    const int row = row0 + r, col = col0 + c;
    if (row < T && col < C)
      out[(long long)row * C + col] = __float2bfloat16(Cs[r * kLDC + c] + b[col]);
  }
}

}  // namespace
}  // namespace e2v

// h2 (T, 2I) bf16; w (C, I) bf16 (nn.Linear layout); b (C) f32; out (T, C)
// bf16. I % 32 == 0. Returns the CUDA launch status.
extern "C" int e2v_geglu_out(const void* h2, const void* w, const void* b, void* out, int T,
                             int I, int C, void* stream) {
  using namespace e2v;
  if (I % kBK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  geglu_out_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h2), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(out), T, I, C);
  return (int)cudaGetLastError();
}

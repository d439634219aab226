// geglu_out_bwd: input gradient of the gate-fused out-projection
// (geglu_out.cu), out = (h * gelu(gate)) W^T + b with [h | gate] = h2:
//   dgated = g W,   dh2 = [dgated gelu(gate) | dgated h gelu'(gate)]
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _geglu_bwd_kernel (:113),
// the feed-forward backward of the C = 1280 levels. The weight and bias
// gradients are not computed here: the caller forms them with plain ops when
// a parameter asks for one.
//
// What bounds it on the H100: a 2*T*C*I FLOP GEMM (T = 8640, C = 1280,
// I = 5120: 113 GFLOP) whose epilogue reads the (T, 2I) h2 once and writes
// the (T, 2I) dh2 once (177 MB each): the two limits nearly meet at these
// shapes (0.116 ms by bytes at 3.35 TB/s, 0.1145 ms by operations at 989
// TFLOP/s). dgated and the gated product never reach device memory.
// Design: 64x64 tiles of dgated (T x I), 4 warps of 32x32 (2x2 WMMA
// fragments), a K-step of 32 over C: A is the g tile, B the weight slice
// w[c][i] as it lies in nn.Linear layout (row-major over i). The epilogue
// stages the f32 tile in shared memory, reads the matching h and gate
// values, recomputes gelu and its derivative in f32 and writes both halves
// of dh2. Row tails (T = 8640 = 135 tiles exactly, 2400 = 37.5) and column
// tails are masked, not padded.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kLDA = kBK + 8;
constexpr int kLDB = kBN + 8;
constexpr int kLDC = kBN + 4;

__global__ void __launch_bounds__(kThreads)
    geglu_out_bwd_kernel(const bf16* __restrict__ h2, const bf16* __restrict__ g,
                         const bf16* __restrict__ w, bf16* __restrict__ dh2, int T, int I,
                         int C) {
  __shared__ __align__(128) bf16 As[kBM * kLDA];
  __shared__ __align__(128) bf16 Bs[kBK * kLDB];
  __shared__ __align__(128) float Cs[kBM * kLDC];

  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < C; k0 += kBK) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      // A: 64 rows x 4 vectors of 8 along c
      const int ar = idx >> 2, akv = (idx & 3) * 8;
      Vec8 av = zero_vec8();
      if (row0 + ar < T) av = load_vec8(g + (long long)(row0 + ar) * C + k0 + akv);
      store_vec8(As + ar * kLDA + akv, av);
      // B: 32 rows (c) x 8 vectors of 8 along i
      const int br = idx >> 3, bcv = (idx & 7) * 8;
      Vec8 bv = zero_vec8();
      if (col0 + bcv < I) bv = load_vec8(w + (long long)(k0 + br) * I + col0 + bcv);
      store_vec8(Bs + br * kLDB + bcv, bv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragA fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * kLDA + kk * 16, kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * 16 * kLDB + wc * 32 + j * 16, kLDB);
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
    if (row < T && col < I) {
      const long long idx = (long long)row * 2 * I + col;
      const float hv = __bfloat162float(h2[idx]);
      const float gv = __bfloat162float(h2[idx + I]);
      float gelu, dgelu;
      gelu_erf_grad(gv, gelu, dgelu);
      const float dg = Cs[r * kLDC + c];
      dh2[idx] = __float2bfloat16(dg * gelu);
      dh2[idx + I] = __float2bfloat16(dg * hv * dgelu);
    }
  }
}

}  // namespace
}  // namespace e2v

// h2, dh2 (T, 2I) bf16; g (T, C) bf16; w (C, I) bf16 (nn.Linear layout).
// C % 32 == 0, I % 8 == 0. Returns the CUDA launch status.
extern "C" int e2v_geglu_out_bwd(const void* h2, const void* g, const void* w, void* dh2, int T,
                                 int I, int C, void* stream) {
  using namespace e2v;
  if (C % kBK != 0 || I % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((I + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  geglu_out_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h2), static_cast<const bf16*>(g), static_cast<const bf16*>(w),
      static_cast<bf16*>(dh2), T, I, C);
  return (int)cudaGetLastError();
}

// geglu_f32 / geglu_f32_bwd: the f32 counterparts of geglu_out /
// geglu_out_bwd,
//   out = (h * gelu_erf(g)) W^T + b,            h2 = [h | g] (T, 2I), W (C, I),
//   dh2 = [dgated gelu(g) | dgated h gelu'(g)],  dgated = dout W.
//
// Replaces (JAX package, eeg2video_tpu/ops/geglu.py), where it runs on f32
// operands (fused_geglu_out tests no dtype, :434): _geglu_pallas :87
// (_geglu_kernel :59) and _geglu_bwd_pallas :131 (_geglu_bwd_kernel :113).
//
// What bounds it on the H100: one 2 T I C product at the FP32 rate without
// tensor cores (67 TFLOP/s), far above the bytes of h2, W and the output at
// the model's shapes.
//
// Design: a plain SIMT GEMM. The forward's block owns 64 rows x 128 output
// columns and walks I in 32-wide chunks: the gated (64, 32) A tile is
// computed from h2 on its way into shared memory (the gate is applied once
// per block and element: C / 128 times in all), the (128, 32) W tile beside
// it; each thread accumulates 4 x 8 outputs in registers. The backward's
// block owns 64 rows x 64 inner columns of dgated, walks C in 32-wide chunks,
// and applies the gate's backward to its registers in the epilogue, writing
// both halves of dh2. Sums run in order: the same bits on every run.
#include "f32_tiles.cuh"

namespace e2v {
namespace f32k {
namespace {

constexpr int kK = 32;       // the k-width of a chunk
constexpr int kLDK = kK + 1;

__global__ void __launch_bounds__(kThreads)
    geglu_f32_kernel(const float* __restrict__ h2, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int T, int I,
                     int C) {
  __shared__ float As[64 * kLDK];   // gated [row][k]
  __shared__ float Bs[128 * kLDK];  // W [col][k]
  const int row0 = blockIdx.y * 64, col0 = blockIdx.x * 128, t_y = ty(), t_x = tx();
  float acc[4][8];
  zero(acc);
  for (int k0 = 0; k0 < I; k0 += kK) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < 64 * kK; i += kThreads) {
      const int r = i / kK, k = i % kK;
      float v = 0.0f;
      if (row0 + r < T && k0 + k < I) {
        const float* hr = h2 + (long long)(row0 + r) * 2 * I;
        v = hr[k0 + k] * gelu_erf(hr[I + k0 + k]);
      }
      As[r * kLDK + k] = v;
    }
    for (int i = threadIdx.x; i < 128 * kK; i += kThreads) {
      const int c = i / kK, k = i % kK;
      Bs[c * kLDK + k] =
          (col0 + c < C && k0 + k < I) ? w[(long long)(col0 + c) * I + k0 + k] : 0.0f;
    }
    __syncthreads();
    mm<4, 8, kK>(acc, As, kLDK, 1, Bs, 1, kLDK);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * t_y + i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + t_x + 16 * j;
      if (c < C) out[(long long)row * C + c] = acc[i][j] + b[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    geglu_f32_bwd_kernel(const float* __restrict__ h2, const float* __restrict__ g,
                         const float* __restrict__ w, float* __restrict__ dh2, int T, int I,
                         int C) {
  constexpr int kLDJ = 64 + 1;
  __shared__ float As[64 * kLDK];  // dout [row][k]
  __shared__ float Bs[kK * kLDJ];  // W [k][j]
  const int row0 = blockIdx.y * 64, j0 = blockIdx.x * 64, t_y = ty(), t_x = tx();
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < C; k0 += kK) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * kK; i += kThreads) {
      const int r = i / kK, k = i % kK;
      As[r * kLDK + k] =
          (row0 + r < T && k0 + k < C) ? g[(long long)(row0 + r) * C + k0 + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < kK * 64; i += kThreads) {
      const int k = i / 64, j = i % 64;
      Bs[k * kLDJ + j] = (k0 + k < C && j0 + j < I) ? w[(long long)(k0 + k) * I + j0 + j] : 0.0f;
    }
    __syncthreads();
    mm<4, 4, kK>(acc, As, kLDK, 1, Bs, kLDJ, 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * t_y + i;
    if (row >= T) continue;
    const float* hr = h2 + (long long)row * 2 * I;
    float* dr = dh2 + (long long)row * 2 * I;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + t_x + 16 * j;
      if (col >= I) continue;
      float gelu, dgelu;
      gelu_erf_grad(hr[I + col], gelu, dgelu);
      dr[col] = acc[i][j] * gelu;
      dr[I + col] = acc[i][j] * hr[col] * dgelu;
    }
  }
}

}  // namespace
}  // namespace f32k
}  // namespace e2v

// h2 (T, 2I), w (C, I) (nn.Linear layout), b (C), out (T, C); all f32,
// contiguous. Returns the CUDA launch status.
extern "C" int e2v_geglu_f32(const void* h2, const void* w, const void* b, void* out, int T,
                             int I, int C, void* stream) {
  using namespace e2v::f32k;
  if (T == 0 || C == 0) return 0;
  const dim3 grid((C + 127) / 128, (T + 63) / 64);
  geglu_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h2), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), T, I, C);
  return (int)cudaGetLastError();
}

// dh2 (T, 2I) of e2v_geglu_f32 from h2 and the output's gradient g (T, C);
// all f32, contiguous. Returns the CUDA launch status.
extern "C" int e2v_geglu_f32_bwd(const void* h2, const void* g, const void* w, void* dh2, int T,
                                 int I, int C, void* stream) {
  using namespace e2v::f32k;
  if (T == 0 || I == 0) return 0;
  const dim3 grid((I + 63) / 64, (T + 63) / 64);
  geglu_f32_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h2), static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<float*>(dh2), T, I, C);
  return (int)cudaGetLastError();
}

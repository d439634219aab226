// int8_dense: weight-only int8 dense layer,
//   out[m, n] = (sum_k bf16(x[m, k]) * bf16(w_q[k, n])) * scale[n] + bias[n],
// f32 accumulation, f32 in and out.
//
// Replaces (JAX package): eeg2video_tpu/ops/int8_dense.py _int8_dense_kernel
// (:62, pallas_call at :76), the five layers of the 894M-parameter semantic
// MLP behind `serve --semantic_int8` (310 -> 4 x 10000 -> 59136, about 100
// rows per call).
//
// What bounds it on the H100: bytes. A middle layer streams a (10016, 10240)
// int8 weight (102.6 MB) against 20.5 GFLOP: 0.031 ms at 3.35 TB/s versus
// 0.021 ms at 989 TFLOP/s. The weight must cross memory once; the small
// activation is re-read by every block and has to come from L2.
// Design (the Pallas grid keeps all of K for 512 columns in VMEM, 5 MB, which
// no SM holds, so it is not carried over):
//  - a pre-pass rounds x to bf16 once into a zero-padded (M, Kp) workspace,
//    so the blocks re-read 2 bytes an element instead of 4;
//  - a block owns 128 output columns and up to 112 rows (7 WMMA row tiles:
//    the 100-row serving chunk in one tile; more rows take more row blocks),
//    and walks its K range in steps of 64: the int8 tile is loaded with
//    16-byte accesses along N, converted exactly to bf16 on its way to shared
//    memory, and the next step's tiles are already in registers while the
//    tensor cores (bf16 WMMA, f32 accumulators in registers) work on this one;
//  - 10240 columns are only 80 such blocks for 132 SMs, so K is split over
//    gridDim.y blocks that write f32 partial sums, and a second pass adds them
//    in a fixed order (no atomics: the result is the same bits every run),
//    then applies scale and bias. With one split the epilogue is in-kernel.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kRowTiles = 7;
constexpr int kBM = kRowTiles * 16;  // 112
constexpr int kBN = 128, kBK = 64;
constexpr int kThreads = 256;        // 8 warps, one 16-column strip each
constexpr int kLDA = kBK + 8;
constexpr int kLDB = kBN + 8;
constexpr int kLDS = 20;             // per-warp f32 staging tile
constexpr int kAVecs = (kBM * kBK / 8 + kThreads - 1) / kThreads;  // 4
constexpr int kWVecs = kBK * kBN / 16 / kThreads;                  // 2

__global__ void round_to_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ xb, int M,
                                     int K, int Kp) {
  const long long total = (long long)M * Kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(i / Kp), k = (int)(i % Kp);
    xb[i] = __float2bfloat16(k < K ? x[(long long)m * K + k] : 0.0f);
  }
}

// 16 int8 values (one 16-byte load) -> 16 bf16 values, exactly.
__device__ __forceinline__ void store_int8x16_as_bf16(bf16* dst, const uint4& v) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  Vec8 lo, hi;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    lo.h[e] = __float2bfloat16((float)b[e]);
    hi.h[e] = __float2bfloat16((float)b[e + 8]);
  }
  store_vec8(dst, lo);
  store_vec8(dst + 8, hi);
}

// grid (Np / 128, splits, row blocks). splits == 1: out gets the finished
// result. splits > 1: part[(split, m, n)] gets this block's f32 partial sum.
__global__ void __launch_bounds__(kThreads)
    int8_dense_kernel(const bf16* __restrict__ xb, const int8_t* __restrict__ wq,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ part, int M, int Kp, int Np,
                      int n_out) {
  __shared__ __align__(128) bf16 As[kBM * kLDA];
  __shared__ __align__(128) bf16 Bs[kBK * kLDB];
  __shared__ __align__(128) float Stage[(kThreads / 32) * 16 * kLDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.z * kBM;
  const int splits = gridDim.y;
  const int ksteps = (Kp + kBK - 1) / kBK;
  const int step_begin = (int)((long long)ksteps * blockIdx.y / splits);
  const int step_end = (int)((long long)ksteps * (blockIdx.y + 1) / splits);

  FragC acc[kRowTiles];
#pragma unroll
  for (int i = 0; i < kRowTiles; ++i) wmma::fill_fragment(acc[i], 0.0f);

  uint4 a_reg[kAVecs], w_reg[kWVecs];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto prefetch = [&](int step) {
    const int k0 = step * kBK;
#pragma unroll
    for (int v = 0; v < kAVecs; ++v) {
      const int idx = tid + v * kThreads;  // (row, 8-wide k vector)
      const int r = idx >> 3, kv = (idx & 7) * 8;
      const int row = row0 + r, k = k0 + kv;
      a_reg[v] = zero;
      if (r < kBM && row < M && k < Kp)
        a_reg[v] = *reinterpret_cast<const uint4*>(xb + (long long)row * Kp + k);
    }
#pragma unroll
    for (int v = 0; v < kWVecs; ++v) {
      const int idx = tid + v * kThreads;  // (k row, 16-wide n group)
      const int r = idx >> 3, g = (idx & 7) * 16;
      const int k = k0 + r;
      w_reg[v] = zero;
      if (k < Kp) w_reg[v] = *reinterpret_cast<const uint4*>(wq + (long long)k * Np + col0 + g);
    }
  };

  if (step_begin < step_end) prefetch(step_begin);
  for (int step = step_begin; step < step_end; ++step) {
#pragma unroll
    for (int v = 0; v < kAVecs; ++v) {
      const int idx = tid + v * kThreads;
      const int r = idx >> 3, kv = (idx & 7) * 8;
      if (r < kBM) *reinterpret_cast<uint4*>(As + r * kLDA + kv) = a_reg[v];
    }
#pragma unroll
    for (int v = 0; v < kWVecs; ++v) {
      const int idx = tid + v * kThreads;
      const int r = idx >> 3, g = (idx & 7) * 16;
      store_int8x16_as_bf16(Bs + r * kLDB + g, w_reg[v]);
    }
    __syncthreads();
    if (step + 1 < step_end) prefetch(step + 1);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, Bs + (kk * 16) * kLDB + warp * 16, kLDB);
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        FragA fa;
        wmma::load_matrix_sync(fa, As + (i * 16) * kLDA + kk * 16, kLDA);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
  }

  // epilogue: each warp passes its 16x16 tiles through its own staging tile
  float* stage = Stage + warp * 16 * kLDS;
  const int c = lane & 15;
  const int col = col0 + warp * 16 + c;
  const float s = scale[col];
  const float b = col < n_out ? bias[col] : 0.0f;
#pragma unroll
  for (int i = 0; i < kRowTiles; ++i) {
    wmma::store_matrix_sync(stage, acc[i], kLDS, wmma::mem_row_major);
    __syncwarp();
    for (int r = lane >> 4; r < 16; r += 2) {
      const int row = row0 + i * 16 + r;
      if (row < M) {
        const float v = stage[r * kLDS + c];
        if (splits == 1) {
          if (col < n_out) out[(long long)row * n_out + col] = v * s + b;
        } else {
          part[((long long)blockIdx.y * M + row) * Np + col] = v;
        }
      }
    }
    __syncwarp();
  }
}

// out[m, n] = (part[0, m, n] + part[1, m, n] + ...) * scale[n] + bias[n]
__global__ void int8_dense_reduce_kernel(const float* __restrict__ part,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out, int M, int Np, int n_out,
                                         int splits) {
  const long long total = (long long)M * n_out;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(i / n_out), n = (int)(i % n_out);
    float acc = 0.0f;
    for (int sp = 0; sp < splits; ++sp) acc += part[((long long)sp * M + m) * Np + n];
    out[i] = acc * scale[n] + bias[n];
  }
}

}  // namespace
}  // namespace e2v

// x (M, K) f32; wq (Kp, Np) int8, N contiguous; scale (Np) f32; bias (n_out)
// f32; out (M, n_out) f32. Workspaces from the caller: xb (M, Kp) bf16, and
// part (splits, M, Np) f32 when splits > 1 (else unused). Kp % 32 == 0,
// Np % 128 == 0, K <= Kp, n_out <= Np. Returns the CUDA launch status.
extern "C" int e2v_int8_dense(const void* x, const void* wq, const void* scale,
                              const void* bias, void* out, void* xb, void* part, int M, int K,
                              int Kp, int Np, int n_out, int splits, void* stream) {
  using namespace e2v;
  if (M < 1 || Kp % 32 != 0 || Np % kBN != 0 || K > Kp || n_out > Np || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long xn = (long long)M * Kp;
  const int xblocks = (int)((xn + 255) / 256 < 1024 ? (xn + 255) / 256 : 1024);
  round_to_bf16_kernel<<<xblocks, 256, 0, st>>>(static_cast<const float*>(x),
                                                static_cast<bf16*>(xb), M, K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Np / kBN, splits, (M + kBM - 1) / kBM);
  int8_dense_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(xb), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(part), M, Kp, Np, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long on = (long long)M * n_out;
  const int rblocks = (int)((on + 255) / 256 < 2048 ? (on + 255) / 256 : 2048);
  int8_dense_reduce_kernel<<<rblocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), M, Np, n_out, splits);
  return (int)cudaGetLastError();
}

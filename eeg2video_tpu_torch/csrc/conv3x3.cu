// conv3x3_gn_silu: implicit-GEMM 3x3, stride-1, SAME convolution on NHWC
// bf16 with the GroupNorm-apply + SiLU prologue and a bias/temb epilogue.
//
// Replaces (JAX package): eeg2video_tpu/ops/conv2d.py _conv3x3_t_kernel (:48),
// the 13 level-0 resnet convolutions of a UNet forward (Cout = 320).
//
//   out[n, y, x, co] = bias[co] + temb[n, co]
//       + sum_{dy, dx, ci} a[n, y+dy-1, x+dx-1, ci] * w[co, dy, dx, ci]
//   a = bf16(silu(x * scale[n, ci] + shift[n, ci]))  inside the image,
//   a = 0                                           in the padded border.
// Zero padding applies AFTER the prologue: the border is 0, not silu(shift)
// (ops/conv2d.py:67-79 zeroes the plane before writing the interior).
// Optional stats: (sum, sum of squares) over pixels of the STORED bf16 output
// per (image, channel), the partials the following GroupNorm needs
// (ops/conv2d.py:115-121). Output tiles of different blocks share an image,
// so each block writes its own partial into a (pixel blocks, 2, Cout) buffer
// and the wrapper adds an image's partials in a fixed order: no atomics, the
// same bits every run (a served clip must not depend on what ran beside it).
// This needs H*W % 64 == 0, so that a block's pixels are of one image.
//
// What bounds it on the H100: 2*N*H*W*9*Cin*Cout FLOPs (12 x 36 x 64 pixels,
// Cin = Cout = 320: 32 GFLOP), compute-bound; the prologue's expf per input
// element is recomputed for each of the 9 taps.
// Design: GEMM with M = pixels, N = Cout, K = 9 taps x Cin. A block owns a
// 64-pixel x 64-channel output tile (4 warps of 32x32, 2x2 WMMA fragments);
// the K loop walks taps and 32-channel slices: each step gathers the shifted
// pixels (zero outside the image), applies the prologue in f32 and stores
// the bf16 A tile; the B tile comes from the weight laid out (Cout, 3, 3, Cin)
// (the wrapper permutes the PyTorch (Cout, Cin, 3, 3) weight once per call).
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kLDA = kBK + 8;
constexpr int kLDC = kBN + 4;

__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ temb,
                   bf16* __restrict__ out, float* __restrict__ stats, int N, int H, int W,
                   int Cin, int Cout) {
  __shared__ __align__(128) bf16 As[kBM * kLDA];
  __shared__ __align__(128) bf16 Bs[kBN * kLDA];
  __shared__ __align__(128) float Cs[kBM * kLDC];

  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int HW = H * W;
  const long long M = (long long)N * HW;
  const long long p0 = (long long)blockIdx.y * kBM;
  const int co0 = blockIdx.x * kBN;

  // the two A rows (pixels) this thread gathers, decoded once
  int pn[2], py[2], px[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int r = (threadIdx.x + v * kThreads) >> 2;
    const long long p = p0 + r;
    if (p < M) {
      pn[v] = (int)(p / HW);
      const int rem = (int)(p % HW);
      py[v] = rem / W;
      px[v] = rem % W;
    } else {
      pn[v] = -1;
      py[v] = px[v] = 0;
    }
  }

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int idx = threadIdx.x + v * kThreads;
        const int r = idx >> 2, kv = (idx & 3) * 8;
        const int ci = c0 + kv;
        Vec8 a = zero_vec8();
        const int ys = py[v] + dy, xs = px[v] + dx;
        if (pn[v] >= 0 && ci < Cin && ys >= 0 && ys < H && xs >= 0 && xs < W) {
          a = load_vec8(x + (((long long)pn[v] * H + ys) * W + xs) * Cin + ci);
          const float* sc = scale + (long long)pn[v] * Cin + ci;
          const float* sh = shift + (long long)pn[v] * Cin + ci;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            a.h[e] = __float2bfloat16(silu(__bfloat162float(a.h[e]) * sc[e] + sh[e]));
        }
        store_vec8(As + r * kLDA + kv, a);
        const int co = co0 + r;
        Vec8 b = zero_vec8();
        if (co < Cout && ci < Cin) b = load_vec8(w + ((long long)co * 9 + tap) * Cin + ci);
        store_vec8(Bs + r * kLDA + kv, b);
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
    const long long p = p0 + r;
    const int co = co0 + c;
    if (p < M && co < Cout) {
      float v = Cs[r * kLDC + c] + bias[co];
      if (temb != nullptr) v += temb[(p / HW) * Cout + co];
      const bf16 o = __float2bfloat16(v);
      out[p * Cout + co] = o;
      Cs[r * kLDC + c] = __bfloat162float(o);  // stats read the stored value
    }
  }
  if (stats == nullptr) return;
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int c = threadIdx.x, co = co0 + c;
    if (co < Cout) {
      float s = 0.0f, s2 = 0.0f;
      for (int r = 0; r < kBM && p0 + r < M; ++r) {
        const float v = Cs[r * kLDC + c];
        s += v;
        s2 += v * v;
      }
      stats[((long long)blockIdx.y * 2) * Cout + co] = s;
      stats[((long long)blockIdx.y * 2 + 1) * Cout + co] = s2;
    }
  }
}

}  // namespace
}  // namespace e2v

// x (N, H, W, Cin) bf16; scale, shift (N, Cin) f32; w (Cout, 3, 3, Cin) bf16;
// bias (Cout) f32; temb (N, Cout) f32 or null; out (N, H, W, Cout) bf16;
// stats (N * H * W / 64, 2, Cout) f32 per-block partials, or null (then
// H * W % 64 == 0). Cin % 8 == 0. Returns the CUDA launch status.
extern "C" int e2v_conv3x3(const void* x, const void* scale, const void* shift, const void* w,
                           const void* bias, const void* temb, void* out, void* stats, int N,
                           int H, int W, int Cin, int Cout, void* stream) {
  using namespace e2v;
  if (Cin % 8 != 0 || (stats != nullptr && (H * W) % kBM != 0))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const dim3 grid((Cout + kBN - 1) / kBN, (unsigned)((M + kBM - 1) / kBM));
  conv3x3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(temb), static_cast<bf16*>(out),
      static_cast<float*>(stats), N, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

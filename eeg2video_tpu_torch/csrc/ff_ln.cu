// ff_ln: the whole pre-LN GEGLU feed-forward block with its residual,
//   out = x + (h * gelu_erf(g)) Wo^T + bo,   [h | g] = LN(x) Wp^T + bp.
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _ff_kernel (:213), the
// C <= 640 feed-forward of every BasicTransformerBlock at levels 0 and 1.
//
// Rounding follows the Pallas kernel: LayerNorm in f32, xn cast to bf16
// before the first GEMM, h2 = xn Wp^T + bp kept in f32 up to the gate, the
// gated product cast to bf16 before the second GEMM, residual and bias added
// in f32. gelu uses erff (the Pallas kernel's rational erf approximation
// exists only because Mosaic has no erf).
//
// What bounds it on the H100: two GEMMs of 2*T*C*2I and 2*T*I*C FLOPs
// (I = 4C): at T = 27648, C = 320 about 45 GFLOP, compute-bound. The one
// thing that must not happen is the (T, 2I) intermediate reaching device
// memory (a 283 MB round trip per call at level 0).
// Design: one block owns 32 token rows and all C output columns. The LN'd
// rows stay in shared memory as bf16; the inner dimension is walked in
// 64-wide chunks: GEMM1 computes the chunk's h and g columns into shared
// memory (f32), the gate turns them into a bf16 chunk, and GEMM2 adds that
// chunk's contribution to the (32, C) output accumulator, which lives in
// registers as WMMA fragments: 8 warps x C/64 fragments of 16x16 f32, i.e.
// 80 accumulator registers per thread at C = 640. That register budget is
// what fixes the 32-row tile; shared memory is ~71 KB at C = 640.
// Weights are read as WMMA B fragments straight from global memory (L2
// resident across blocks); staging them is a later optimisation.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBM = 32;   // token rows per block
constexpr int kIC = 64;   // inner-dimension chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLDH = 2 * kIC + 4;  // f32 [h | g] chunk
constexpr int kLDG = kIC + 8;      // bf16 gated chunk

template <int CT>
constexpr size_t ff_smem_bytes() {
  return (size_t)kBM * (CT * 64 + 8) * sizeof(bf16) + (size_t)kBM * kLDH * sizeof(float) +
         (size_t)kBM * kLDG * sizeof(bf16) + (size_t)kWarps * 256 * sizeof(float);
}

// CT = C / 64; each warp owns CT of the (kBM/16) x (C/16) output tiles.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    ff_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const bf16* __restrict__ wp,
                 const float* __restrict__ bp, const bf16* __restrict__ wo,
                 const float* __restrict__ bo, bf16* __restrict__ out, int T, int I,
                 float eps) {
  constexpr int C = CT * 64;
  constexpr int LDX = C + 8;
  constexpr int NT = CT;  // (kBM/16) * (C/16) / kWarps
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  float* H2 = reinterpret_cast<float*>(Xn + kBM * LDX);
  bf16* Gd = reinterpret_cast<bf16*>(H2 + kBM * kLDH);
  float* Stage = reinterpret_cast<float*>(Gd + kBM * kLDG);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBM;

  // LayerNorm, one warp per row (kBM / kWarps rows each), f32
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = row0 + r;
    float v[C / 32];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] = row < T ? __bfloat162float(x[(long long)row * C + lane + 32 * i]) : 0.0f;
      sum += v[i];
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] -= mu;
      sq += v[i] * v[i];
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      const float xn = row < T ? v[i] * rstd * gamma[c] + beta[c] : 0.0f;
      Xn[r * LDX + c] = __float2bfloat16(xn);
    }
  }

  FragC acc[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) wmma::fill_fragment(acc[i], 0.0f);

  // GEMM1 tiles: 2 row tiles x 8 column tiles (4 of h, 4 of g); 2 per warp
  const int g1_rt = warp & 1;
  const int g1_ct = (warp >> 1) * 2;

  for (int j0 = 0; j0 < I; j0 += kIC) {
    __syncthreads();  // Xn written / previous chunk's H2 reads done
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int ct = g1_ct + t;
      const int wcol = ct < 4 ? j0 + ct * 16 : I + j0 + (ct - 4) * 16;
      FragC c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        FragA fa;
        FragBCol fb;
        wmma::load_matrix_sync(fa, Xn + g1_rt * 16 * LDX + kk * 16, LDX);
        wmma::load_matrix_sync(fb, wp + (long long)wcol * C + kk * 16, C);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(H2 + g1_rt * 16 * kLDH + ct * 16, c, kLDH,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // gate: h * gelu(g) in f32, cast to bf16
    for (int e = threadIdx.x; e < kBM * kIC; e += kThreads) {
      const int r = e / kIC, c = e % kIC;
      const float hv = H2[r * kLDH + c] + bp[j0 + c];
      const float gv = H2[r * kLDH + kIC + c] + bp[I + j0 + c];
      Gd[r * kLDG + c] = __float2bfloat16(hv * gelu_erf(gv));
    }
    __syncthreads();
    // GEMM2: acc += Gd (32 x 64) . Wo[:, j0:j0+64]^T
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int t = warp * NT + i;
      const int rt = t / (C / 16), ct = t % (C / 16);
#pragma unroll
      for (int kk = 0; kk < kIC / 16; ++kk) {
        FragA fa;
        FragBCol fb;
        wmma::load_matrix_sync(fa, Gd + rt * 16 * kLDG + kk * 16, kLDG);
        wmma::load_matrix_sync(fb, wo + (long long)ct * 16 * I + j0 + kk * 16, I);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }

  // epilogue: residual + bias in f32, one 16x16 tile at a time per warp
  float* St = Stage + warp * 256;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int t = warp * NT + i;
    const int rt = t / (C / 16), ct = t % (C / 16);
    wmma::store_matrix_sync(St, acc[i], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = row0 + rt * 16 + e / 16;
      const int col = ct * 16 + e % 16;
      if (row < T) {
        const long long idx = (long long)row * C + col;
        out[idx] = __float2bfloat16(__bfloat162float(x[idx]) + St[e] + bo[col]);
      }
    }
    __syncwarp();
  }
}

template <int CT>
int launch_ff(const bf16* x, const float* gamma, const float* beta, const bf16* wp,
              const float* bp, const bf16* wo, const float* bo, bf16* out, int T, int I,
              float eps, void* stream) {
  const dim3 grid((T + kBM - 1) / kBM);
  const size_t smem = ff_smem_bytes<CT>();
  E2V_LAUNCH(ff_ln_kernel<CT>, grid, kThreads, smem, stream, x, gamma, beta, wp, bp, wo, bo,
             out, T, I, eps);
}

}  // namespace
}  // namespace e2v

// x, out (T, C) bf16; gamma, beta (C) f32; wp (2I, C) bf16 (nn.Linear
// layout), bp (2I) f32; wo (C, I) bf16, bo (C) f32. C % 64 == 0, C <= 640,
// I % 64 == 0. Returns the CUDA launch status.
extern "C" int e2v_ff_ln(const void* x, const void* gamma, const void* beta, const void* wp,
                         const void* bp, const void* wo, const void* bo, void* out, int T,
                         int C, int I, float eps, void* stream) {
  using namespace e2v;
  const bf16* xx = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const bf16* p = static_cast<const bf16*>(wp);
  const float* pb = static_cast<const float*>(bp);
  const bf16* o = static_cast<const bf16*>(wo);
  const float* ob = static_cast<const float*>(bo);
  bf16* y = static_cast<bf16*>(out);
  if (C % 64 != 0 || I % kIC != 0) return (int)cudaErrorInvalidValue;
  switch (C / 64) {
    case 1: return launch_ff<1>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 2: return launch_ff<2>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 3: return launch_ff<3>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 4: return launch_ff<4>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 5: return launch_ff<5>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 6: return launch_ff<6>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 7: return launch_ff<7>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 8: return launch_ff<8>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 9: return launch_ff<9>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    case 10: return launch_ff<10>(xx, g, b, p, pb, o, ob, y, T, I, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

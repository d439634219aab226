// ff_ln_bwd: input gradient of the whole pre-LN GEGLU feed-forward block
// with its residual (ff_ln.cu), everything recomputed from (x, g):
//   out = x + (h * gelu(gate)) Wo^T + bo,  [h | gate] = LN(x) Wp^T + bp
//   dx  = g + LN'(((g Wo) .* [gelu(gate) | h gelu'(gate)]) Wp .* gamma)
//
// Replaces (JAX package): eeg2video_tpu/ops/geglu.py _ff_bwd_kernel (:280).
// Parameter gradients are not computed here: the caller forms them with
// plain ops, and only when a parameter asks for one.
//
// Rounding follows the Pallas kernel: LN in f32, xn cast to bf16 before the
// first GEMM, h2 in f32 up to the gate, dgated = g Wo in f32, the gate's
// backward in f32, dh2 cast to bf16 before the last GEMM, the LayerNorm
// backward and the residual in f32.
//
// What bounds it on the H100: three GEMMs per inner chunk where the forward
// has two: 2*T*C*2I (h2) + 2*T*C*I (dgated) + 2*T*2I*C (dh2 Wp) = 10*T*C*I
// FLOPs, compute-bound; as in the forward the (T, 2I) intermediates (h2 and
// dh2) never reach device memory.
// Design: the forward's walk. One block owns 32 token rows and all C
// columns; xn and g stay in shared memory as bf16; the inner dimension is
// walked in 64-wide chunks: h2 chunk (32 x 128, f32) and dgated chunk
// (32 x 64, f32) into shared memory, the gate backward turns them into a
// bf16 dh2 chunk (32 x 128), and the last GEMM adds dh2 Wp[chunk] to the
// (32, C) accumulator held in registers as WMMA fragments (8 warps x C/64
// fragments, 80 registers a thread at C = 640). After the walk the
// accumulator is staged in shared memory (over xn and g, which are done
// with) and one warp per row applies gamma, the two LN means and the
// residual.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBM = 32;   // token rows per block
constexpr int kIC = 64;   // inner-dimension chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLDH = 2 * kIC + 4;  // f32 [h | gate] chunk
constexpr int kLDD = kIC + 4;      // f32 dgated chunk
constexpr int kLDG = 2 * kIC + 8;  // bf16 [dh | dgate] chunk

template <int CT>
constexpr size_t ff_bwd_smem_bytes() {
  return (size_t)2 * kBM * (CT * 64 + 8) * sizeof(bf16) + (size_t)kBM * kLDH * sizeof(float) +
         (size_t)kBM * kLDD * sizeof(float) + (size_t)kBM * kLDG * sizeof(bf16) +
         (size_t)2 * kBM * sizeof(float);
}

template <int CT>
__global__ void __launch_bounds__(kThreads)
    ff_ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const bf16* __restrict__ wp, const float* __restrict__ bp,
                     const bf16* __restrict__ wo, bf16* __restrict__ dx, int T, int I,
                     float eps) {
  constexpr int C = CT * 64;
  constexpr int LDX = C + 8;
  constexpr int LDA = C + 4;  // f32 staging of the accumulator, over Xn and Gs
  constexpr int NT = CT;      // (kBM/16) * (C/16) / kWarps
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Xn + kBM * LDX;
  float* H2 = reinterpret_cast<float*>(Gs + kBM * LDX);
  float* DG = H2 + kBM * kLDH;
  bf16* DH = reinterpret_cast<bf16*>(DG + kBM * kLDD);
  float* mu_s = reinterpret_cast<float*>(DH + kBM * kLDG);
  float* rstd_s = mu_s + kBM;
  float* Acc = reinterpret_cast<float*>(smem);
  static_assert(kBM * LDA * sizeof(float) <= 2 * kBM * LDX * sizeof(bf16),
                "the accumulator staging must fit over Xn and Gs");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBM;

  // LayerNorm (one warp per row, f32) and the g tile
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
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      const float xn = row < T ? v[i] * rstd * gamma[c] + beta[c] : 0.0f;
      Xn[r * LDX + c] = __float2bfloat16(xn);
      Gs[r * LDX + c] = row < T ? g[(long long)row * C + c] : __float2bfloat16(0.0f);
    }
  }

  FragC acc[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) wmma::fill_fragment(acc[i], 0.0f);

  // h2 tiles: 2 row tiles x 8 column tiles (4 of h, 4 of gate), 2 per warp;
  // dgated tiles: 2 x 4, one per warp
  const int rt = warp & 1;
  const int g1_ct = (warp >> 1) * 2;
  const int dg_ct = warp >> 1;

  for (int j0 = 0; j0 < I; j0 += kIC) {
    __syncthreads();  // Xn/Gs written; the previous chunk's H2/DG/DH reads done
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
        wmma::load_matrix_sync(fa, Xn + rt * 16 * LDX + kk * 16, LDX);
        wmma::load_matrix_sync(fb, wp + (long long)wcol * C + kk * 16, C);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(H2 + rt * 16 * kLDH + ct * 16, c, kLDH, wmma::mem_row_major);
    }
    {
      // dgated chunk = g Wo[:, j0:j0+64]: B(k = c, n = i) = wo[c * I + i]
      FragC c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, Gs + rt * 16 * LDX + kk * 16, LDX);
        wmma::load_matrix_sync(fb, wo + (long long)kk * 16 * I + j0 + dg_ct * 16, I);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(DG + rt * 16 * kLDD + dg_ct * 16, c, kLDD, wmma::mem_row_major);
    }
    __syncthreads();
    // gate backward in f32: dh = dgated gelu(gate), dgate = dgated h gelu'(gate)
    for (int e = threadIdx.x; e < kBM * kIC; e += kThreads) {
      const int r = e / kIC, c = e % kIC;
      const float hv = H2[r * kLDH + c] + bp[j0 + c];
      const float gv = H2[r * kLDH + kIC + c] + bp[I + j0 + c];
      float gelu, dgelu;
      gelu_erf_grad(gv, gelu, dgelu);
      const float dg = DG[r * kLDD + c];
      DH[r * kLDG + c] = __float2bfloat16(dg * gelu);
      DH[r * kLDG + kIC + c] = __float2bfloat16(dg * hv * dgelu);
    }
    __syncthreads();
    // acc += dh2 chunk (32 x 128) . Wp[chunk rows, :]: B(k = j, n = c) = wp[j * C + c]
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int t = warp * NT + i;
      const int art = t / (C / 16), act = t % (C / 16);
#pragma unroll
      for (int kk = 0; kk < 2 * kIC / 16; ++kk) {
        const int wrow = kk < kIC / 16 ? j0 + kk * 16 : I + j0 + (kk - kIC / 16) * 16;
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, DH + art * 16 * kLDG + kk * 16, kLDG);
        wmma::load_matrix_sync(fb, wp + (long long)wrow * C + act * 16, C);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }

  __syncthreads();  // every warp is done with Xn and Gs
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int t = warp * NT + i;
    const int art = t / (C / 16), act = t % (C / 16);
    wmma::store_matrix_sync(Acc + art * 16 * LDA + act * 16, acc[i], LDA, wmma::mem_row_major);
  }
  __syncthreads();

  // LayerNorm backward and the residual, one warp per row
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = row0 + r;
    if (row >= T) continue;
    const float mu = mu_s[r], rstd = rstd_s[r];
    float dxn[C / 32], xhat[C / 32];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      xhat[i] = (__bfloat162float(x[(long long)row * C + c]) - mu) * rstd;
      dxn[i] = Acc[r * LDA + c] * gamma[c];
      s1 += dxn[i];
      s2 += dxn[i] * xhat[i];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const long long idx = (long long)row * C + lane + 32 * i;
      dx[idx] = __float2bfloat16(__bfloat162float(g[idx]) +
                                 rstd * (dxn[i] - m1 - xhat[i] * m2));
    }
  }
}

template <int CT>
int launch_ff_bwd(const bf16* x, const bf16* g, const float* gamma, const float* beta,
                  const bf16* wp, const float* bp, const bf16* wo, bf16* dx, int T, int I,
                  float eps, void* stream) {
  const dim3 grid((T + kBM - 1) / kBM);
  const size_t smem = ff_bwd_smem_bytes<CT>();
  E2V_LAUNCH(ff_ln_bwd_kernel<CT>, grid, kThreads, smem, stream, x, g, gamma, beta, wp, bp, wo,
             dx, T, I, eps);
}

}  // namespace
}  // namespace e2v

// x, g, dx (T, C) bf16; gamma, beta (C) f32; wp (2I, C) bf16 (nn.Linear
// layout), bp (2I) f32; wo (C, I) bf16. C % 64 == 0, C <= 640, I % 64 == 0.
// Returns the CUDA launch status.
extern "C" int e2v_ff_ln_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                             const void* wp, const void* bp, const void* wo, void* dx, int T,
                             int C, int I, float eps, void* stream) {
  using namespace e2v;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* gg = static_cast<const bf16*>(g);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const bf16* p = static_cast<const bf16*>(wp);
  const float* pb = static_cast<const float*>(bp);
  const bf16* o = static_cast<const bf16*>(wo);
  bf16* y = static_cast<bf16*>(dx);
  if (C % 64 != 0 || I % kIC != 0) return (int)cudaErrorInvalidValue;
  switch (C / 64) {
    case 1: return launch_ff_bwd<1>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 2: return launch_ff_bwd<2>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 3: return launch_ff_bwd<3>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 4: return launch_ff_bwd<4>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 5: return launch_ff_bwd<5>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 6: return launch_ff_bwd<6>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 7: return launch_ff_bwd<7>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 8: return launch_ff_bwd<8>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 9: return launch_ff_bwd<9>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    case 10: return launch_ff_bwd<10>(xx, gg, ga, be, p, pb, o, y, T, I, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

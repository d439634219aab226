// The attention forward kernel, shared by its two entry points:
//   flash_attention.cu       packed (., L, H*D) operands, one or two KV segments
//   flash_attention_bhld.cu  head-major (B, H, L, D) operands, one segment
// The operand layout is the template parameter HEAD_MAJOR, so each entry
// point compiles only its own addressing and the packed instantiations carry
// nothing of the other layout.
//
// Computes, per head h:
//   out = softmax(scale * q [K0 | K1]^T + [bias0 | 0]) [V0 | V1]
// Packed: head h is columns h*D .. h*D+D of rows of H*D contiguous values.
// K0/V0 (and bias0) belong to batch element n / m and are shared by its m
// query groups; K1/V1 are per n and optional (single-segment call: m = 1, no
// K1). Segment 1 takes no bias: the reference pads the mask with zeros for
// the previous-frame half (models/attention3d.py:161-165).
// Head-major: head h of batch element n starts at n * batch stride + h * head
// stride, and a row is D contiguous values (row stride D); m = 1, no K1, no
// bias.
//
// What bounds it on the H100: at the generation shapes the score GEMMs are
// small-K (D = 40/80/160) and the kernel is bound by the softmax's
// exponentials and shared-memory traffic, not by HBM: q/k/v are read once
// per (query tile, head) and nothing of size Lq x Lkv leaves the SM.
// Design: one block = 64 query rows of one head (4 warps x 16 rows); KV is
// streamed in 64-row tiles through shared memory; QK^T and PV run on bf16
// WMMA tiles with f32 accumulation; the online softmax keeps the TRUE
// running max per row (the Pallas kernel instead clamps base-2 scores to
// +-100, which is exact only while the row max stays <= 100 base-2 units;
// that shortcut is not carried over). D is padded to a multiple of 16 inside
// shared memory only; KV tails (Lkv = 77) are masked to -inf.
// An optional f32 output lse (N, H, Lq) holds, in natural-log units, the
// log-sum-exp of each row's scaled (and biased) scores, m + log(l) of the
// running softmax: the residual the backward recomputes the probabilities
// from. It is a template parameter, so that the kernel the inference paths
// launch (no lse) carries nothing of it: keeping the running max alive to the
// epilogue costs registers, and the short cross-attention calls are bound by
// how many blocks fit an SM.
#pragma once

#include "flash_tiles.cuh"

namespace e2v {
namespace {

struct AttnArgs {
  const bf16* q;
  long long q_so, q_si;  // packed: strides of (n / m, n % m), in elements
  const bf16* k0;
  long long k0_so;
  const bf16* v0;
  long long v0_so;
  const bf16* k1;
  long long k1_so, k1_si;
  const bf16* v1;
  long long v1_so, v1_si;
  const float* bias0;  // (N / m, Lkv0) f32 or null
  bf16* out;
  long long o_so, o_si;
  float* lse;  // (N, H, Lq) f32, natural log, or null
  int m, lq, lkv0, lkv1, head_dim, hd;
  float scale_log2;  // softmax scale * log2(e): scores in base-2 units
  long long q_hs, k_hs, v_hs, o_hs;  // head-major: head strides (*_so: batch strides)
};

template <int DP>
constexpr size_t attn_smem_bytes() {
  return (size_t)(kBQ + 2 * kBKV) * (DP + 8) * sizeof(bf16) +
         (size_t)kWarps * 16 * (kLDS * sizeof(float) + kLDP * sizeof(bf16) +
                                (DP + 4) * sizeof(float));
}

template <int DP, bool LSE, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const AttnArgs a) {
  constexpr int LDQ = DP + 8;
  constexpr int LDO = DP + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LDQ;
  bf16* Vs = Ks + kBKV * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + kBKV * LDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kWarps * 16 * kLDS);
  float* Os = reinterpret_cast<float*>(Ps + kWarps * 16 * kLDP);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int nb = n / a.m, nj = n % a.m;
  const int D = a.head_dim;
  const long long hoff = (long long)h * D;

  load_rows<DP, kThreads>(
      Qs, a.q + (HEAD_MAJOR ? n * a.q_so + h * a.q_hs : nb * a.q_so + nj * a.q_si + hoff),
      HEAD_MAJOR ? D : a.hd, q0, a.lq, D);
  float* Sw = Ss + warp * 16 * kLDS;
  bf16* Pw = Ps + warp * 16 * kLDP;
  float* Ow = Os + warp * 16 * LDO;
  for (int i = lane; i < 16 * LDO; i += 32) Ow[i] = 0.0f;
  float mrow[16], lrow[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
  }

  for (int seg = 0; seg < 2; ++seg) {
    const bf16 *kb, *vb;
    const float* bias = nullptr;
    int lkv;
    if (seg == 0) {
      kb = a.k0 + (HEAD_MAJOR ? n * a.k0_so + h * a.k_hs : nb * a.k0_so + hoff);
      vb = a.v0 + (HEAD_MAJOR ? n * a.v0_so + h * a.v_hs : nb * a.v0_so + hoff);
      lkv = a.lkv0;
      if (!HEAD_MAJOR && a.bias0 != nullptr) bias = a.bias0 + (long long)nb * a.lkv0;
    } else {
      if (HEAD_MAJOR || a.k1 == nullptr) break;
      kb = a.k1 + nb * a.k1_so + nj * a.k1_si + hoff;
      vb = a.v1 + nb * a.v1_so + nj * a.v1_si + hoff;
      lkv = a.lkv1;
    }
    for (int kv0 = 0; kv0 < lkv; kv0 += kBKV) {
      __syncthreads();  // previous tile's K/V (and the Q load) are settled
      load_rows<DP, kThreads>(Ks, kb, HEAD_MAJOR ? D : a.hd, kv0, lkv, D);
      load_rows<DP, kThreads>(Vs, vb, HEAD_MAJOR ? D : a.hd, kv0, lkv, D);
      __syncthreads();

      // S = Q K^T for this warp's 16 query rows
#pragma unroll
      for (int j = 0; j < kBKV / 16; ++j) {
        FragC c;
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          FragA fa;
          FragBCol fb;
          wmma::load_matrix_sync(fa, Qs + warp * 16 * LDQ + kk * 16, LDQ);
          wmma::load_matrix_sync(fb, Ks + j * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(c, fa, fb, c);
        }
        wmma::store_matrix_sync(Sw + j * 16, c, kLDS, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax with the true running max, base 2
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float s[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;
          const int col = kv0 + c;
          if (col < lkv) {
            float v = Sw[r * kLDS + c] * a.scale_log2;
            if (bias != nullptr) v += bias[col] * kLog2e;
            s[t] = v;
          } else {
            s[t] = -INFINITY;
          }
        }
        const float m_old = mrow[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
        const float alpha = (m_old == -INFINITY) ? 0.0f : exp2f(m_old - m_new);
        const float p0 = (s[0] == -INFINITY) ? 0.0f : exp2f(s[0] - m_new);
        const float p1 = (s[1] == -INFINITY) ? 0.0f : exp2f(s[1] - m_new);
        lrow[r] = lrow[r] * alpha + warp_sum(p0 + p1);
        mrow[r] = m_new;
        Pw[r * kLDP + lane] = __float2bfloat16(p0);
        Pw[r * kLDP + lane + 32] = __float2bfloat16(p1);
        for (int d = lane; d < DP; d += 32) Ow[r * LDO + d] *= alpha;
      }
      __syncwarp();

      // O = O + P V
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        FragC c;
        wmma::load_matrix_sync(c, Ow + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk) {
          FragA fa;
          FragBRow fb;
          wmma::load_matrix_sync(fa, Pw + kk * 16, kLDP);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * LDQ + j * 16, LDQ);
          wmma::mma_sync(c, fa, fb, c);
        }
        wmma::store_matrix_sync(Ow + j * 16, c, LDO, wmma::mem_row_major);
      }
      __syncwarp();
    }
  }

  bf16* ob = a.out + (HEAD_MAJOR ? n * a.o_so + h * a.o_hs
                                 : nb * a.o_so + nj * a.o_si + hoff);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row < a.lq) {
      const float inv = 1.0f / lrow[r];
      for (int d = lane; d < D; d += 32)
        ob[(long long)row * (HEAD_MAJOR ? D : a.hd) + d] = __float2bfloat16(Ow[r * LDO + d] * inv);
      if (LSE && lane == 0)
        a.lse[((long long)n * gridDim.y + h) * a.lq + row] =
            (mrow[r] + log2f(lrow[r])) * kLn2;
    }
  }
}

template <int DP, bool HEAD_MAJOR>
int launch_flash(const AttnArgs& a, int heads, int n_total, void* stream) {
  const dim3 grid((a.lq + kBQ - 1) / kBQ, heads, n_total);
  const size_t smem = attn_smem_bytes<DP>();
  void (*kernel)(const AttnArgs) = a.lse != nullptr ? flash_fwd_kernel<DP, true, HEAD_MAJOR>
                                                    : flash_fwd_kernel<DP, false, HEAD_MAJOR>;
  E2V_LAUNCH(kernel, grid, kThreads, smem, stream, a);
}

// head_dim -> the instantiation padded to the next multiple of 16
template <bool HEAD_MAJOR>
int dispatch_flash(const AttnArgs& a, int heads, int n_total, void* stream) {
  switch ((a.head_dim + 15) / 16) {
    case 1: return launch_flash<16, HEAD_MAJOR>(a, heads, n_total, stream);
    case 2: return launch_flash<32, HEAD_MAJOR>(a, heads, n_total, stream);
    case 3: return launch_flash<48, HEAD_MAJOR>(a, heads, n_total, stream);
    case 4: return launch_flash<64, HEAD_MAJOR>(a, heads, n_total, stream);
    case 5: return launch_flash<80, HEAD_MAJOR>(a, heads, n_total, stream);
    case 6: return launch_flash<96, HEAD_MAJOR>(a, heads, n_total, stream);
    case 7: return launch_flash<112, HEAD_MAJOR>(a, heads, n_total, stream);
    case 8: return launch_flash<128, HEAD_MAJOR>(a, heads, n_total, stream);
    case 9: return launch_flash<144, HEAD_MAJOR>(a, heads, n_total, stream);
    case 10: return launch_flash<160, HEAD_MAJOR>(a, heads, n_total, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace e2v

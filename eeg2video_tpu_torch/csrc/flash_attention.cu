// flash_attention_fwd: packed multi-head attention forward over one or two
// KV segments.
//
// Replaces (JAX package, eeg2video_tpu/ops/attention.py):
//   _packed_single_kernel (:415), the whole-KV packed forward, and
//   _packed_dual_kernel (:566), the sparse-causal [K0 | K_prev] forward.
//   It also computes what _packed_kernel (:487) computes (online softmax over
//   KV tiles); that body is not reached by the generation path.
//
// Computes, per head h (columns h*D .. h*D+D of the packed (., L, H*D) rows):
//   out = softmax(scale * q [K0 | K1]^T + [bias0 | 0]) [V0 | V1]
// K0/V0 (and bias0) belong to batch element n / m and are shared by its m
// query groups; K1/V1 are per n and optional (single-segment call: m = 1, no
// K1). Segment 1 takes no bias: the reference pads the mask with zeros for
// the previous-frame half (models/attention3d.py:161-165).
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
// No lse output yet: training will need it.
#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 64;  // KV rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLDS = kBKV + 4;  // f32 score tile leading dim
constexpr int kLDP = kBKV + 8;  // bf16 probability tile leading dim

struct AttnArgs {
  const bf16* q;
  long long q_so, q_si;  // strides of (n / m, n % m), in elements
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
  int m, lq, lkv0, lkv1, head_dim, hd;
  float scale_log2;  // softmax scale * log2(e): scores in base-2 units
};

template <int DP>
constexpr size_t attn_smem_bytes() {
  return (size_t)(kBQ + 2 * kBKV) * (DP + 8) * sizeof(bf16) +
         (size_t)kWarps * 16 * (kLDS * sizeof(float) + kLDP * sizeof(bf16) +
                                (DP + 4) * sizeof(float));
}

// rows [row0, row0 + 64) x head columns [0, D) of a packed matrix into a
// (64, DP) bf16 tile; rows past nrows and columns past D are zero.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int hd,
                                          int row0, int nrows, int D) {
  constexpr int kVPR = DP / 8;
  for (int i = threadIdx.x; i < 64 * kVPR; i += kThreads) {
    const int r = i / kVPR, d = (i % kVPR) * 8;
    const int row = row0 + r;
    Vec8 v = zero_vec8();
    if (row < nrows && d < D) v = load_vec8(src + (long long)row * hd + d);
    store_vec8(dst + r * (DP + 8) + d, v);
  }
}

template <int DP>
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

  load_rows<DP>(Qs, a.q + nb * a.q_so + nj * a.q_si + hoff, a.hd, q0, a.lq, D);
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
      kb = a.k0 + nb * a.k0_so + hoff;
      vb = a.v0 + nb * a.v0_so + hoff;
      lkv = a.lkv0;
      if (a.bias0 != nullptr) bias = a.bias0 + (long long)nb * a.lkv0;
    } else {
      if (a.k1 == nullptr) break;
      kb = a.k1 + nb * a.k1_so + nj * a.k1_si + hoff;
      vb = a.v1 + nb * a.v1_so + nj * a.v1_si + hoff;
      lkv = a.lkv1;
    }
    for (int kv0 = 0; kv0 < lkv; kv0 += kBKV) {
      __syncthreads();  // previous tile's K/V (and the Q load) are settled
      load_rows<DP>(Ks, kb, a.hd, kv0, lkv, D);
      load_rows<DP>(Vs, vb, a.hd, kv0, lkv, D);
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

  bf16* ob = a.out + nb * a.o_so + nj * a.o_si + hoff;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row < a.lq) {
      const float inv = 1.0f / lrow[r];
      for (int d = lane; d < D; d += 32)
        ob[(long long)row * a.hd + d] = __float2bfloat16(Ow[r * LDO + d] * inv);
    }
  }
}

template <int DP>
int launch_flash(const AttnArgs& a, int n_total, void* stream) {
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.hd / a.head_dim, n_total);
  const size_t smem = attn_smem_bytes<DP>();
  E2V_LAUNCH(flash_fwd_kernel<DP>, grid, kThreads, smem, stream, a);
}

}  // namespace
}  // namespace e2v

// Strides are in elements; every row is hd contiguous bf16 values. k1/v1 and
// bias0 may be null. Returns the CUDA launch status.
extern "C" int e2v_flash_attention_fwd(
    const void* q, long long q_so, long long q_si, const void* k0, long long k0_so,
    const void* v0, long long v0_so, const void* k1, long long k1_so, long long k1_si,
    const void* v1, long long v1_so, long long v1_si, const void* bias0, void* out,
    long long o_so, long long o_si, int n_total, int m, int lq, int lkv0, int lkv1,
    int heads, int head_dim, float scale, void* stream) {
  using namespace e2v;
  AttnArgs a;
  a.q = static_cast<const bf16*>(q);
  a.q_so = q_so;
  a.q_si = q_si;
  a.k0 = static_cast<const bf16*>(k0);
  a.k0_so = k0_so;
  a.v0 = static_cast<const bf16*>(v0);
  a.v0_so = v0_so;
  a.k1 = static_cast<const bf16*>(k1);
  a.k1_so = k1_so;
  a.k1_si = k1_si;
  a.v1 = static_cast<const bf16*>(v1);
  a.v1_so = v1_so;
  a.v1_si = v1_si;
  a.bias0 = static_cast<const float*>(bias0);
  a.out = static_cast<bf16*>(out);
  a.o_so = o_so;
  a.o_si = o_si;
  a.m = m;
  a.lq = lq;
  a.lkv0 = lkv0;
  a.lkv1 = lkv1;
  a.head_dim = head_dim;
  a.hd = heads * head_dim;
  a.scale_log2 = scale * kLog2e;
  switch ((head_dim + 15) / 16) {
    case 1: return launch_flash<16>(a, n_total, stream);
    case 2: return launch_flash<32>(a, n_total, stream);
    case 3: return launch_flash<48>(a, n_total, stream);
    case 4: return launch_flash<64>(a, n_total, stream);
    case 5: return launch_flash<80>(a, n_total, stream);
    case 6: return launch_flash<96>(a, n_total, stream);
    case 7: return launch_flash<112>(a, n_total, stream);
    case 8: return launch_flash<128>(a, n_total, stream);
    case 9: return launch_flash<144>(a, n_total, stream);
    case 10: return launch_flash<160>(a, n_total, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

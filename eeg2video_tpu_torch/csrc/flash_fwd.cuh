// The attention forward kernel, shared by its two entry points:
//   flash_attention.cu       packed (., L, H*D) operands, one or two KV segments
//   flash_attention_bhld.cu  head-major (B, H, L, D) operands, one segment
// The operand layout is the template parameter HEAD_MAJOR, so each entry
// point compiles only its own addressing and the packed instantiations carry
// nothing of the other layout. The instantiations themselves are compiled in
// flash_fwd_d*.cu, a few head dims per file, so that the build runs them in
// parallel; the entry points only dispatch.
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
// What bounds it on the H100: the two products, 4 Lq Lkv D operations per
// head, against bytes that are read once per (query block, head); at D = 40
// the softmax's exponentials (one per score) and the shared-memory reads of
// the operand tiles come close to the products' own time.
// Design (the FlashAttention-2 form, on mma.sync.m16n8k16):
//   - one block = 128 query rows of one head (8 warps x 16 rows), or 64 rows
//     (4 warps) where 128-row blocks would leave SMs idle or fewer warps
//     resident (block_warps in flash_tiles.cuh); a warp whose 16 rows all lie
//     past Lq skips the products (the short level-2/3 calls);
//   - K and V stream in 64-row tiles through a two-stage ring in shared
//     memory, filled by cp.async: tile t+1's K and V are in flight while tile
//     t computes, and V is its own copy group, so that Q K^T starts before V
//     has landed;
//   - S = Q K^T stays in the C fragments; a row's 64 scores sit on the 4
//     lanes of a quad, so its max and sum cost 2 shuffles each; P is rounded
//     to bf16 in registers into the A fragments of P V; O lives in
//     registers and is rescaled there;
//   - the online softmax keeps the TRUE running max per row (the Pallas
//     kernel instead clamps base-2 scores to +-100, which is exact only while
//     the row max stays <= 100 base-2 units; that shortcut is not carried
//     over); scores are in base-2 units (scale_log2);
//   - D is padded to a multiple of 16 in shared memory only (the k-depth of
//     Q K^T): the copies zero-fill columns D .. DP and never read them from
//     device memory; P V skips its last n8 tile where it lies past D (D = 40:
//     5 of 6); KV tails are masked to -inf on the last tile of each segment
//     only; rows past Lq are not written.
// An optional f32 output lse (N, H, Lq) holds, in natural-log units, the
// log-sum-exp of each row's scaled (and biased) scores, m + log(l) of the
// running softmax: the residual the backward recomputes the probabilities
// from. It is a template parameter, so that the kernel the inference paths
// launch (no lse) carries nothing of it.
#pragma once

#include "flash_tiles.cuh"

namespace e2v {

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

// Q (16 rows a warp), the K and V rings, the bias ring
template <int DP>
constexpr size_t fwd_smem_bytes(int warps) {
  return (size_t)(warps * 16 + 4 * kTileKV) * tile_ld<DP>() * sizeof(bf16) +
         (size_t)2 * kTileKV * sizeof(float);
}

template <int DP, bool LSE, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kMaxThreads, (DP <= 64 ? 2 : 1))
    flash_fwd_kernel(const AttnArgs a) {
  constexpr int LD = tile_ld<DP>();
  constexpr int KT = DP / 16;  // k-steps of Q K^T
  constexpr int NT = DP / 8;   // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const int bq = blockDim.x / 2;  // 16 rows a warp
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + bq * LD;
  bf16* Vs = Ks + 2 * kTileKV * LD;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kTileKV * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int nb = n / a.m, nj = n % a.m;
  const int D = a.head_dim;
  const long long hoff = (long long)h * D;
  const long long rs = HEAD_MAJOR ? D : a.hd;

  const bf16* kb0 = a.k0 + (HEAD_MAJOR ? n * a.k0_so + h * a.k_hs : nb * a.k0_so + hoff);
  const bf16* vb0 = a.v0 + (HEAD_MAJOR ? n * a.v0_so + h * a.v_hs : nb * a.v0_so + hoff);
  const bool two = !HEAD_MAJOR && a.k1 != nullptr;
  const bf16* kb1 = two ? a.k1 + nb * a.k1_so + nj * a.k1_si + hoff : nullptr;
  const bf16* vb1 = two ? a.v1 + nb * a.v1_so + nj * a.v1_si + hoff : nullptr;
  const float* bias =
      (!HEAD_MAJOR && a.bias0 != nullptr) ? a.bias0 + (long long)nb * a.lkv0 : nullptr;
  // KV tiles of both segments in one sequence: tiles [0, t0n) are segment 0
  const int t0n = (a.lkv0 + kTileKV - 1) / kTileKV;
  const int tn = t0n + (two ? (a.lkv1 + kTileKV - 1) / kTileKV : 0);

  auto issue_k = [&](int t) {
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * kTileKV;
    copy_rows<DP, LD>(Ks + (t & 1) * kTileKV * LD, s1 ? kb1 : kb0, rs, kv0, kTileKV,
                      s1 ? a.lkv1 : a.lkv0, D);
    if (bias != nullptr && !s1) copy_floats(Bs + (t & 1) * kTileKV, bias, kv0, kTileKV, a.lkv0);
    cp_async_commit();
  };
  auto issue_v = [&](int t) {
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * kTileKV;
    copy_rows<DP, LD>(Vs + (t & 1) * kTileKV * LD, s1 ? vb1 : vb0, rs, kv0, kTileKV,
                      s1 ? a.lkv1 : a.lkv0, D);
    cp_async_commit();
  };

  // copy groups in order: Q, K0, V0, then K(t+1), V(t+1) at the top of tile t
  copy_rows<DP, LD>(
      Qs, a.q + (HEAD_MAJOR ? n * a.q_so + h * a.q_hs : nb * a.q_so + nj * a.q_si + hoff), rs,
      q0, bq, a.lq, D);
  cp_async_commit();
  issue_k(0);
  issue_v(0);

  const bf16* Qw = Qs + warp * 16 * LD;
  const bool active = q0 + warp * 16 < a.lq;  // else the warp's rows all lie past Lq
  const bool half_last = D <= DP - 8;  // O's last n8 tile lies past D: skipped
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};

  for (int t = 0; t < tn; ++t) {
    const int st = t & 1;
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * kTileKV;
    const int lkv = s1 ? a.lkv1 : a.lkv0;
    cp_async_wait<1>();  // Q and K(t) have landed; V(t) may still be in flight
    __syncthreads();     // ... for every thread; and tile t-1's ring slot is free
    if (t + 1 < tn) {
      issue_k(t + 1);
      issue_v(t + 1);
    } else {
      cp_async_commit();  // empty groups keep the wait counts uniform
      cp_async_commit();
    }
    if (!active) {  // no products; the block's second barrier all the same
      cp_async_wait<2>();
      __syncthreads();
      continue;
    }

    // S = Q K^T: this warp's 16 rows x 64 columns
    const bf16* Kt = Ks + st * kTileKV * LD;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      load_a<LD>(qa, Qw, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        load_b_rows<LD>(kb, Kt, np * 16, kk * 16, lane);
        mma_16816(s[2 * np], qa, kb[0], kb[1]);
        mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // base-2 logits are sc * s: without a bias the scale is folded into the
    // exponent below (the max commutes with sc > 0); with one, or a negative
    // scale, it is applied here
    float sc = a.scale_log2;
    if (bias != nullptr && !s1) {
      const float* bt = Bs + st * kTileKV;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = fmaf(s[j][e], sc, bt[j * 8 + 2 * tq + (e & 1)] * kLog2e);
      sc = 1.0f;
    } else if (sc < 0.0f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc;
      sc = 1.0f;
    }
    if (kv0 + kTileKV > lkv) {  // the segment's last tile: -inf past its end
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + j * 8 + 2 * tq + (e & 1) >= lkv) s[j][e] = -INFINITY;
    }

    // online softmax, true running max (base-2 units); row r of the thread: g + 8 r
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[r], mx * sc);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = fast_exp2(mrow[r] - m_use);
      mrow[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * r] = fast_exp2(fmaf(s[j][2 * r], sc, -m_use));
        s[j][2 * r + 1] = fast_exp2(fmaf(s[j][2 * r + 1], sc, -m_use));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      lrow[r] = lrow[r] * alpha + sum;  // this lane's share of the row sum
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // P as the A fragments of P V (4 k-steps of 16 KV columns)
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    cp_async_wait<2>();  // V(t) has landed (K(t+1), V(t+1) may be in flight)
    __syncthreads();
    const bf16* Vt = Vs + st * kTileKV * LD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        load_b_cols<LD>(vb, Vt, kk * 16, np * 16, lane);
        mma_16816(o[2 * np], p[kk], vb[0], vb[1]);
        if (np < NT / 2 - 1 || !half_last) mma_16816(o[2 * np + 1], p[kk], vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  const float inv[2] = {1.0f / lrow[0], 1.0f / lrow[1]};
  bf16* ob = a.out + (HEAD_MAJOR ? n * a.o_so + h * a.o_hs : nb * a.o_so + nj * a.o_si + hoff);
  // the warp's own Q rows are free now: they stage its output rows
  store_tile<NT, LD>(ob, rs, o, inv, Qs + warp * 16 * LD, q0 + warp * 16, a.lq, 0, D, lane);
  if (LSE && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < a.lq)
        a.lse[((long long)n * gridDim.y + h) * a.lq + row] = (mrow[r] + log2f(lrow[r])) * kLn2;
    }
  }
}

template <int DP, bool HEAD_MAJOR>
int launch_flash(const AttnArgs& a, int heads, int n_total, void* stream) {
  void (*kernel)(const AttnArgs) = a.lse != nullptr ? flash_fwd_kernel<DP, true, HEAD_MAJOR>
                                                    : flash_fwd_kernel<DP, false, HEAD_MAJOR>;
  const int warps = block_warps(kernel, fwd_smem_bytes<DP>, a.lq, heads * n_total);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.lq + warps * 16 - 1) / (warps * 16), heads, n_total);
  kernel<<<grid, warps * 32, fwd_smem_bytes<DP>(warps), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiations live in flash_fwd_d*.cu
#define E2V_FWD_EXTERN(DP)                                                            \
  extern template int launch_flash<DP, false>(const AttnArgs&, int, int, void*);     \
  extern template int launch_flash<DP, true>(const AttnArgs&, int, int, void*);
E2V_ATTN_DPS(E2V_FWD_EXTERN)
#undef E2V_FWD_EXTERN
#define E2V_FWD_INSTANTIATE(DP)                                                \
  template int launch_flash<DP, false>(const AttnArgs&, int, int, void*);     \
  template int launch_flash<DP, true>(const AttnArgs&, int, int, void*);

// head_dim -> the instantiation padded to the next multiple of 16
template <bool HEAD_MAJOR>
int dispatch_flash(const AttnArgs& a, int heads, int n_total, void* stream) {
  switch ((a.head_dim + 15) / 16) {
#define E2V_FWD_CASE(DP) \
  case DP / 16: return launch_flash<DP, HEAD_MAJOR>(a, heads, n_total, stream);
    E2V_ATTN_DPS(E2V_FWD_CASE)
#undef E2V_FWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace e2v

// The attention backward kernels, shared by their two entry points:
//   flash_attention_bwd.cu   packed (., L, H*D) operands, one or two KV
//                            segments, optional bias0 and its gradient dbias0
//   flash_attention_bhld.cu  head-major (B, H, L, D) operands, one segment
// The operand layout (HEAD_MAJOR) and the dbias output (DBIAS) are template
// parameters: an instantiation carries only what it was asked for, so a call
// without a bias gradient pays nothing for dbias (same registers, same code).
// The instantiations are compiled in flash_bwd_d*.cu, a few head dims per
// file; the entry points only dispatch.
//
// From q, k0/v0 (shared by the m query groups of a batch element), optional
// k1/v1 (per query group), dout, out, the forward's lse (natural log) and an
// optional bias0, per head:
//   p  = exp(scale q k^T + bias - lse)           (recomputed, never stored)
//   dv = p^T dout
//   ds = p * (dout v^T - delta) * scale,          delta = rowsum(dout * out)
//   dq = ds k,   dk = ds^T q
// and dk0/dv0 add up the m query groups that shared K0/V0. With DBIAS,
//   dbias0[b, col] = sum over the m groups, the heads and the query rows of
//                    p * (dout v^T - delta)       (ds before the scale factor)
//
// Two passes, each owning its output tile, so every sum has a fixed order
// and no float atomics are needed (same bits every run):
//   dq pass : one block = 128 (or 64) query rows of one head, 16 a warp
//             (block_warps in flash_tiles.cuh picks the height); it
//             walks all KV tiles of both segments, K and V streaming through
//             a two-stage cp.async ring. It also computes delta for its rows
//             and writes it to a (N, H, Lq) f32 scratch for the second pass.
//             S = Q K^T and dP = dO V^T stay in C fragments, dS is rounded
//             into A fragments in registers, dQ += dS K takes K through
//             ldmatrix.trans and accumulates in registers.
//   dkv pass: one block = 128 (or 64) KV rows of one head of one segment
//             (from D = 128 on, of one of two column ranges), 16
//             a warp, as the M dimension: S^T = K Q^T and dP^T = V dO^T, so
//             P^T and dS^T are A fragments in registers and feed dV += P^T dO
//             and dK += dS^T Q directly. It walks every query tile that
//             attended its rows (all m groups for segment 0, one group for
//             segment 1), Q, dO, lse and delta streaming through a two-stage
//             cp.async ring. Launched once per segment.
//   dbias   : the segment-0 dkv block adds up its own head's share of dbias0
//             for its rows (each lane keeps its share of its two KV rows; a
//             quad sum at the end) and writes it to a (b, H, Lkv0) f32
//             scratch; the TPU body loops the heads inside one grid cell, here
//             the head sum crosses blocks, so a short third pass
//             (flash_attention_bwd.cu) adds the H partials in head order.
// The query (dkv pass) or KV (dq pass) columns of a tile are taken in chunks
// of 64, 32 or 16 by head dim, so that the f32 accumulators (dK and dV: 2 x
// DP / 2 registers a thread) and the score chunks fit the registers without
// spills up to D = 160.
// The TPU's combined body shares one score recompute between dq and dk/dv by
// keeping a whole sequence resident; no SM holds that, so the split form (the
// JAX package's own fallback) is the one carried over: five products in the
// forward's units become seven (the scores and dout v^T are formed twice).
// Gradients are rounded to bf16 once, from the f32 accumulators. D is padded
// to a multiple of 16 in shared memory only (zero-filled by the copies).
// Head-major operands: head h of batch element n starts at n * batch stride
// (*_so) + h * head stride (*_hs) and a row is D contiguous values; m = 1, no
// k1/v1, no bias; the gradients are contiguous (B, H, L, D).
#pragma once

#include "flash_tiles.cuh"

namespace e2v {

struct BwdArgs {
  const bf16 *q, *k0, *v0, *k1, *v1, *dout, *out;
  const float* lse;    // (N, H, Lq) natural log
  const float* bias0;  // (N / m, Lkv0) f32 or null
  float* delta;        // (N, H, Lq) scratch: written by the dq pass
  bf16 *dq, *dk0, *dv0, *dk1, *dv1;  // contiguous (N, Lq, hd), (N/m, Lkv0, hd), (N, Lkv1, hd)
  long long q_so, q_si, do_so, do_si, o_so, o_si;  // packed: strides of (n / m, n % m)
  long long k0_so, v0_so, k1_so, k1_si, v1_so, v1_si;
  int m, lq, lkv0, lkv1, head_dim, hd, heads;
  float scale, scale_log2;
  float* dbias_part;  // (N / m, H, Lkv0) scratch: per-head dbias0, or null
  long long q_hs, do_hs, o_hs, k_hs, v_hs;  // head-major: head strides
};

// The dkv pass's column split: from DP = 128 on, dK and dV (2 x DP / 2 f32
// registers a thread) leave too few registers for the score chunks, so a
// block accumulates one of two column ranges of dK and dV (the scores are
// formed in both), and the grid has twice the blocks.
template <int DP>
__host__ __device__ constexpr int dkv_split() {
  return DP >= 128 ? 2 : 1;
}
// n8 tiles of dK and dV a dkv block accumulates (even: tiles go in pairs)
template <int DP>
__host__ __device__ constexpr int dkv_tiles() {
  return dkv_split<DP>() == 1 ? DP / 8 : ((DP / 16 + 1) / 2) * 2;
}
// columns of a tile per score chunk: the dq pass's KV columns, the dkv pass's
// query columns (its two accumulators take twice the registers)
template <int DP>
__host__ __device__ constexpr int dq_chunk() {
  return DP <= 64 ? 64 : 32;
}
template <int DP>
__host__ __device__ constexpr int dkv_chunk() {
  return dkv_tiles<DP>() <= 4 ? 64 : dkv_tiles<DP>() <= 12 ? 32 : 16;
}

// Q and dO (16 rows a warp), the K and V rings, the bias ring, delta
template <int DP>
constexpr size_t dq_smem_bytes(int warps) {
  return (size_t)(2 * warps * 16 + 4 * kTileKV) * tile_ld<DP>() * sizeof(bf16) +
         (size_t)(2 * kTileKV + warps * 16) * sizeof(float);
}

// K and V (16 rows a warp), the Q and dO rings, the lse and delta rings
template <int DP>
constexpr size_t dkv_smem_bytes(int warps) {
  return (size_t)(2 * warps * 16 + 4 * kTileQ) * tile_ld<DP>() * sizeof(bf16) +
         (size_t)4 * kTileQ * sizeof(float);
}

template <int DP, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kMaxThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = tile_ld<DP>();
  constexpr int KT = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int KC = dq_chunk<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int bq = blockDim.x / 2;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + bq * LD;
  bf16* Ks = dOs + bq * LD;
  bf16* Vs = Ks + 2 * kTileKV * LD;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kTileKV * LD);
  float* Ds = Bs + 2 * kTileKV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int nb = n / a.m, nj = n % a.m;
  const int D = a.head_dim;
  const long long hoff = (long long)h * D;
  const long long rs = HEAD_MAJOR ? D : a.hd;
  const long long stat = ((long long)n * a.heads + h) * a.lq;

  const bf16* kb0 = a.k0 + (HEAD_MAJOR ? n * a.k0_so + h * a.k_hs : nb * a.k0_so + hoff);
  const bf16* vb0 = a.v0 + (HEAD_MAJOR ? n * a.v0_so + h * a.v_hs : nb * a.v0_so + hoff);
  const bool two = !HEAD_MAJOR && a.k1 != nullptr;
  const bf16* kb1 = two ? a.k1 + nb * a.k1_so + nj * a.k1_si + hoff : nullptr;
  const bf16* vb1 = two ? a.v1 + nb * a.v1_so + nj * a.v1_si + hoff : nullptr;
  const float* bias =
      (!HEAD_MAJOR && a.bias0 != nullptr) ? a.bias0 + (long long)nb * a.lkv0 : nullptr;
  const int t0n = (a.lkv0 + kTileKV - 1) / kTileKV;
  const int tn = t0n + (two ? (a.lkv1 + kTileKV - 1) / kTileKV : 0);

  auto issue_kv = [&](int t) {
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * kTileKV, lkv = s1 ? a.lkv1 : a.lkv0;
    copy_rows<DP, LD>(Ks + (t & 1) * kTileKV * LD, s1 ? kb1 : kb0, rs, kv0, kTileKV, lkv, D);
    copy_rows<DP, LD>(Vs + (t & 1) * kTileKV * LD, s1 ? vb1 : vb0, rs, kv0, kTileKV, lkv, D);
    if (bias != nullptr && !s1) copy_floats(Bs + (t & 1) * kTileKV, bias, kv0, kTileKV, a.lkv0);
    cp_async_commit();
  };

  const bf16* qb = a.q + (HEAD_MAJOR ? n * a.q_so + h * a.q_hs : nb * a.q_so + nj * a.q_si + hoff);
  const bf16* dob =
      a.dout + (HEAD_MAJOR ? n * a.do_so + h * a.do_hs : nb * a.do_so + nj * a.do_si + hoff);
  const bf16* ob = a.out + (HEAD_MAJOR ? n * a.o_so + h * a.o_hs : nb * a.o_so + nj * a.o_si + hoff);
  copy_rows<DP, LD>(Qs, qb, rs, q0, bq, a.lq, D);
  copy_rows<DP, LD>(dOs, dob, rs, q0, bq, a.lq, D);
  issue_kv(0);  // one group with Q and dO

  // delta = rowsum(dout * out) of this warp's 16 rows, read from device
  // memory while the copies are in flight
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float sum = 0.0f;
    if (row < a.lq) {
      for (int c = lane * 8; c < D; c += 256) {
        const Vec8 x = load_vec8(dob + row * rs + c), y = load_vec8(ob + row * rs + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += __bfloat162float(x.h[i]) * __bfloat162float(y.h[i]);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      Ds[warp * 16 + r] = sum;
      if (row < a.lq) a.delta[stat + row] = sum;
    }
  }
  __syncwarp();
  // per row of the thread (g + 8 r): delta, and lse in base-2 units, +inf for
  // rows past Lq so that their recomputed probabilities are 0
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    dl[r] = Ds[warp * 16 + g + 8 * r];
    l2[r] = row < a.lq ? a.lse[stat + row] * kLog2e : INFINITY;
  }

  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;
  const bool active = q0 + warp * 16 < a.lq;  // else the warp's rows all lie past Lq
  const bool half_last = D <= DP - 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int t = 0; t < tn; ++t) {
    const int st = t & 1;
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * kTileKV;
    const int lkv = s1 ? a.lkv1 : a.lkv0;
    cp_async_wait<0>();  // K(t), V(t) (and at t = 0 Q, dO) have landed
    __syncthreads();     // ... for every thread; and tile t-1's ring slot is free
    if (t + 1 < tn) issue_kv(t + 1);
    if (!active) continue;
    const bf16* Kt = Ks + st * kTileKV * LD;
    const bf16* Vt = Vs + st * kTileKV * LD;
    const float* bt = (bias != nullptr && !s1) ? Bs + st * kTileKV : nullptr;
    const bool tail = kv0 + kTileKV > lkv;

#pragma unroll
    for (int c0 = 0; c0 < kTileKV; c0 += KC) {
      if (tail && kv0 + c0 >= lkv) break;  // P is 0 past the segment's end
      // S = Q K^T and dP = dO V^T over KV columns c0 .. c0 + KC
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t qa[4], da[4];
        load_a<LD>(qa, Qw, kk * 16, lane);
        load_a<LD>(da, dOw, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t kb[4], vb[4];
          load_b_rows<LD>(kb, Kt, c0 + np * 16, kk * 16, lane);
          load_b_rows<LD>(vb, Vt, c0 + np * 16, kk * 16, lane);
          mma_16816(s[2 * np], qa, kb[0], kb[1]);
          mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_16816(dp[2 * np], da, vb[0], vb[1]);
          mma_16816(dp[2 * np + 1], da, vb[2], vb[3]);
        }
      }
      // dS = P (dP - delta) scale, P = exp2(S scale_log2 + bias - lse)
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * tq + (e & 1), r = e >> 1;
          float v = s[j][e] * a.scale_log2;
          if (bt != nullptr) v = fmaf(bt[c], kLog2e, v);
          float p = fast_exp2(v - l2[r]);
          if (tail && kv0 + c >= lkv) p = 0.0f;
          s[j][e] = p * (dp[j][e] - dl[r]) * a.scale;
        }
      uint32_t dsa[KC / 16][4];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        dsa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        dsa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        dsa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        dsa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          load_b_cols<LD>(kb, Kt, c0 + kk * 16, np * 16, lane);
          mma_16816(acc[2 * np], dsa[kk], kb[0], kb[1]);
          if (np < NT / 2 - 1 || !half_last) mma_16816(acc[2 * np + 1], dsa[kk], kb[2], kb[3]);
        }
      }
    }
  }

  bf16* dqb = a.dq + (HEAD_MAJOR ? ((long long)n * a.heads + h) * a.lq * D
                                 : (long long)n * a.lq * a.hd + hoff);
  const float one[2] = {1.0f, 1.0f};
  store_tile<NT, LD>(dqb, rs, acc, one, Qs + warp * 16 * LD, q0 + warp * 16, a.lq, 0, D,
                     lane);
}

// seg 0: blockIdx.z is the batch element whose K0/V0 rows this block owns,
// and the m query groups that shared them are walked in order; seg 1:
// blockIdx.z is the query group n. DBIAS (seg 0 only): also this head's
// share of dbias0 for the block's rows, into a.dbias_part.
template <int DP, bool DBIAS, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kMaxThreads)
    flash_bwd_dkv_kernel(const BwdArgs a, const int seg) {
  constexpr int LD = tile_ld<DP>();
  constexpr int KT = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int QC = dkv_chunk<DP>();
  constexpr int SPLIT = dkv_split<DP>();
  constexpr int NH = dkv_tiles<DP>();  // n8 tiles of dK and dV in this block
  extern __shared__ __align__(128) unsigned char smem[];
  const int bkv = blockDim.x / 2;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + bkv * LD;
  bf16* Qs = Vs + bkv * LD;
  bf16* dOs = Qs + 2 * kTileQ * LD;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kTileQ * LD);
  float* Dls = Ls + 2 * kTileQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kv0 = blockIdx.x / SPLIT * bkv;
  const int j_first = blockIdx.x % SPLIT * NH;  // the block's first n8 tile of dK and dV
  const int h = blockIdx.y;
  const int owner = blockIdx.z;
  const int D = a.head_dim;
  const long long hoff = (long long)h * D;
  const long long rs = HEAD_MAJOR ? D : a.hd;

  const bf16 *kb, *vb;
  const float* bias = nullptr;
  bf16 *dkb, *dvb;
  int lkv, n_first, n_count;
  if (HEAD_MAJOR || seg == 0) {
    kb = a.k0 + (HEAD_MAJOR ? owner * a.k0_so + h * a.k_hs : owner * a.k0_so + hoff);
    vb = a.v0 + (HEAD_MAJOR ? owner * a.v0_so + h * a.v_hs : owner * a.v0_so + hoff);
    lkv = a.lkv0;
    if (!HEAD_MAJOR && a.bias0 != nullptr) bias = a.bias0 + (long long)owner * a.lkv0;
    const long long goff = HEAD_MAJOR ? ((long long)owner * a.heads + h) * lkv * D
                                      : (long long)owner * lkv * a.hd + hoff;
    dkb = a.dk0 + goff;
    dvb = a.dv0 + goff;
    n_first = owner * a.m;
    n_count = a.m;
  } else {
    const int nb = owner / a.m, nj = owner % a.m;
    kb = a.k1 + nb * a.k1_so + nj * a.k1_si + hoff;
    vb = a.v1 + nb * a.v1_so + nj * a.v1_si + hoff;
    lkv = a.lkv1;
    dkb = a.dk1 + (long long)owner * lkv * a.hd + hoff;
    dvb = a.dv1 + (long long)owner * lkv * a.hd + hoff;
    n_first = owner;
    n_count = 1;
  }
  const int nqt = (a.lq + kTileQ - 1) / kTileQ;
  const int tn = n_count * nqt;  // query tiles of every group, in order

  auto issue_q = [&](int t) {
    const int st = t & 1;
    const int n = n_first + t / nqt, q0 = (t % nqt) * kTileQ;
    const int nb = n / a.m, nj = n % a.m;
    const long long stat = ((long long)n * a.heads + h) * a.lq;
    copy_rows<DP, LD>(
        Qs + st * kTileQ * LD,
        a.q + (HEAD_MAJOR ? n * a.q_so + h * a.q_hs : nb * a.q_so + nj * a.q_si + hoff), rs, q0,
        kTileQ, a.lq, D);
    copy_rows<DP, LD>(
        dOs + st * kTileQ * LD,
        a.dout + (HEAD_MAJOR ? n * a.do_so + h * a.do_hs : nb * a.do_so + nj * a.do_si + hoff),
        rs, q0, kTileQ, a.lq, D);
    copy_floats(Ls + st * kTileQ, a.lse + stat, q0, kTileQ, a.lq);
    copy_floats(Dls + st * kTileQ, a.delta + stat, q0, kTileQ, a.lq);
    cp_async_commit();
  };

  copy_rows<DP, LD>(Ks, kb, rs, kv0, bkv, lkv, D);
  copy_rows<DP, LD>(Vs, vb, rs, kv0, bkv, lkv, D);
  issue_q(0);  // one group with K and V

  // bias of the thread's two KV rows (g + 8 r), base 2
  float b2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = kv0 + warp * 16 + g + 8 * r;
    b2[r] = (bias != nullptr && col < lkv) ? bias[col] * kLog2e : 0.0f;
  }
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  const bool active = kv0 + warp * 16 < lkv;  // else the warp's rows all lie past Lkv
  const bool half_last = D <= DP - 8;
  float dk[NH][4], dv[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  float db[2] = {0.0f, 0.0f};  // DBIAS: this lane's share of its two rows' sums

  for (int t = 0; t < tn; ++t) {
    const int st = t & 1;
    const int q0 = (t % nqt) * kTileQ;
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tn) issue_q(t + 1);
    if (!active) continue;
    const bf16* Qt = Qs + st * kTileQ * LD;
    const bf16* dOt = dOs + st * kTileQ * LD;
    const float* Lt = Ls + st * kTileQ;
    const float* Dt = Dls + st * kTileQ;
    const bool tail = q0 + kTileQ > a.lq;

#pragma unroll
    for (int c0 = 0; c0 < kTileQ; c0 += QC) {
      if (tail && q0 + c0 >= a.lq) break;  // P is 0 past Lq
      // S^T = K Q^T and dP^T = V dO^T over query columns c0 .. c0 + QC
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Kw, kk * 16, lane);
        load_a<LD>(va, Vw, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t qb[4], ob[4];
          load_b_rows<LD>(qb, Qt, c0 + np * 16, kk * 16, lane);
          load_b_rows<LD>(ob, dOt, c0 + np * 16, kk * 16, lane);
          mma_16816(s[2 * np], ka, qb[0], qb[1]);
          mma_16816(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_16816(dp[2 * np], va, ob[0], ob[1]);
          mma_16816(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // P^T and dS^T; query rows past Lq (the last tile only) give 0
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * tq + (e & 1), r = e >> 1;
          float p = fast_exp2(fmaf(s[j][e], a.scale_log2, fmaf(-Lt[c], kLog2e, b2[r])));
          if (tail && q0 + c >= a.lq) p = 0.0f;
          const float ds_nat = p * (dp[j][e] - Dt[c]);
          if (DBIAS) db[r] += ds_nat;
          s[j][e] = p;
          dp[j][e] = ds_nat * a.scale;
        }
      uint32_t pa[QC / 16][4], dsa[QC / 16][4];
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        dsa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        dsa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        dsa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        dsa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      }
      // dV += P^T dO, dK += dS^T Q, over the block's n8 tiles j_first + j
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NH / 2; ++np) {
          const int j0 = j_first + 2 * np;
          if (SPLIT > 1 && j0 >= NT) break;  // DP = 144: the second range has 8 of 10
          const bool second = j0 + 1 < NT - 1 || !half_last;
          uint32_t ob[4], qb[4];
          load_b_cols<LD>(ob, dOt, c0 + kk * 16, j0 * 8, lane);
          mma_16816(dv[2 * np], pa[kk], ob[0], ob[1]);
          if (second) mma_16816(dv[2 * np + 1], pa[kk], ob[2], ob[3]);
          load_b_cols<LD>(qb, Qt, c0 + kk * 16, j0 * 8, lane);
          mma_16816(dk[2 * np], dsa[kk], qb[0], qb[1]);
          if (second) mma_16816(dk[2 * np + 1], dsa[kk], qb[2], qb[3]);
        }
      }
    }
  }

  // the warp's own K and V rows are free now: they stage dK and dV
  const float one[2] = {1.0f, 1.0f};
  store_tile<NH, LD>(dkb, rs, dk, one, Ks + warp * 16 * LD, kv0 + warp * 16, lkv, j_first * 8,
                     D, lane);
  store_tile<NH, LD>(dvb, rs, dv, one, Vs + warp * 16 * LD, kv0 + warp * 16, lkv, j_first * 8,
                     D, lane);
  if (DBIAS && j_first == 0) {  // both column ranges form the same sums: the first writes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
      const int col = kv0 + warp * 16 + g + 8 * r;
      if (tq == 0 && col < lkv) a.dbias_part[((long long)owner * a.heads + h) * lkv + col] = db[r];
    }
  }
}

// dq pass, then the dkv pass per segment; a non-null dbias_part selects the
// DBIAS instantiation of the segment-0 pass
template <int DP, bool HEAD_MAJOR>
int launch_bwd(const BwdArgs& a, int n_total, cudaStream_t stream) {
  void (*dq)(const BwdArgs) = flash_bwd_dq_kernel<DP, HEAD_MAJOR>;
  void (*dkv)(const BwdArgs, int) = flash_bwd_dkv_kernel<DP, false, HEAD_MAJOR>;
  void (*dkv0)(const BwdArgs, int) = dkv;
  if constexpr (!HEAD_MAJOR) {
    if (a.dbias_part != nullptr) dkv0 = flash_bwd_dkv_kernel<DP, true, false>;
  }
  const bool two = !HEAD_MAJOR && a.k1 != nullptr;
  constexpr int split = dkv_split<DP>();
  const int wq = block_warps(dq, dq_smem_bytes<DP>, a.lq, a.heads * n_total);
  const int w0 = block_warps(dkv0, dkv_smem_bytes<DP>, a.lkv0, a.heads * (n_total / a.m) * split);
  const int w1 = two ? block_warps(dkv, dkv_smem_bytes<DP>, a.lkv1, a.heads * n_total * split)
                     : w0;
  if (wq == 0 || w0 == 0 || w1 == 0) return (int)cudaErrorInvalidValue;
  const size_t smem_dq = dq_smem_bytes<DP>(wq);
  const size_t smem_0 = dkv_smem_bytes<DP>(w0), smem_1 = dkv_smem_bytes<DP>(w1);
  const dim3 grid_q((a.lq + wq * 16 - 1) / (wq * 16), a.heads, n_total);
  dq<<<grid_q, wq * 32, smem_dq, stream>>>(a);
  const dim3 grid_0((a.lkv0 + w0 * 16 - 1) / (w0 * 16) * split, a.heads, n_total / a.m);
  dkv0<<<grid_0, w0 * 32, smem_0, stream>>>(a, 0);
  if (two) {
    const dim3 grid_1((a.lkv1 + w1 * 16 - 1) / (w1 * 16) * split, a.heads, n_total);
    dkv<<<grid_1, w1 * 32, smem_1, stream>>>(a, 1);
  }
  return (int)cudaGetLastError();
}

// the instantiations live in flash_bwd_d*.cu
#define E2V_BWD_EXTERN(DP)                                                        \
  extern template int launch_bwd<DP, false>(const BwdArgs&, int, cudaStream_t);  \
  extern template int launch_bwd<DP, true>(const BwdArgs&, int, cudaStream_t);
E2V_ATTN_DPS(E2V_BWD_EXTERN)
#undef E2V_BWD_EXTERN
#define E2V_BWD_INSTANTIATE(DP)                                            \
  template int launch_bwd<DP, false>(const BwdArgs&, int, cudaStream_t);  \
  template int launch_bwd<DP, true>(const BwdArgs&, int, cudaStream_t);

// head_dim -> the instantiation padded to the next multiple of 16
template <bool HEAD_MAJOR>
int dispatch_bwd(const BwdArgs& a, int n_total, cudaStream_t stream) {
  switch ((a.head_dim + 15) / 16) {
#define E2V_BWD_CASE(DP) \
  case DP / 16: return launch_bwd<DP, HEAD_MAJOR>(a, n_total, stream);
    E2V_ATTN_DPS(E2V_BWD_CASE)
#undef E2V_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace e2v

// The attention backward kernels, shared by their two entry points:
//   flash_attention_bwd.cu   packed (., L, H*D) operands, one or two KV
//                            segments, optional bias0 and its gradient dbias0
//   flash_attention_bhld.cu  head-major (B, H, L, D) operands, one segment
// The operand layout (HEAD_MAJOR) and the dbias output (DBIAS) are template
// parameters: an instantiation carries only what it was asked for, so a call
// without a bias gradient pays nothing for dbias (same registers, same code).
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
//   dq pass : one block = 64 query rows of one head; it walks all KV tiles
//             of both segments. It also computes delta for its rows and
//             writes it to a (N, H, Lq) f32 scratch for the second pass.
//   dkv pass: one block = 64 KV rows of one head of one segment; it walks
//             every query tile that attended them (all m groups for segment
//             0, one group for segment 1). Launched once per segment.
//   dbias   : the segment-0 dkv block adds up its own head's share of dbias0
//             for its 64 columns while it walks the query tiles (one register:
//             lane r of a warp keeps the sum of the warp's KV row r) and
//             writes it to a (b, H, Lkv0) f32 scratch; the TPU body loops the
//             heads inside one grid cell, here the head sum crosses blocks,
//             so a short third pass (flash_attention_bwd.cu) adds the H
//             partials in head order.
// The TPU's combined body shares one score recompute between dq and dk/dv by
// keeping a whole sequence resident; no SM holds that, so the split form (the
// JAX package's own fallback) is the one carried over: five products in the
// forward's units become seven (the scores and dout v^T are formed twice).
// All products are bf16 WMMA tiles with f32 accumulation; gradients are
// rounded to bf16 once, from the f32 accumulators, which live in registers
// (DP/16 fragments in the dq pass, 2 DP/16 in the dkv pass). D is padded to
// a multiple of 16 in shared memory only.
// Head-major operands: head h of batch element n starts at n * batch stride
// (*_so) + h * head stride (*_hs) and a row is D contiguous values; m = 1, no
// k1/v1, no bias; the gradients are contiguous (B, H, L, D).
#pragma once

#include "flash_tiles.cuh"

namespace e2v {
namespace {

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

template <int DP>
constexpr size_t bwd_smem_bytes(int bf16_tiles_per_warp) {
  return (size_t)4 * 64 * (DP + 8) * sizeof(bf16) +
         (size_t)kWarps * 16 * (2 * kLDS * sizeof(float) +
                                bf16_tiles_per_warp * kLDP * sizeof(bf16)) +
         (size_t)2 * 64 * sizeof(float);
}

// one 16x16 f32 accumulator tile -> bf16 rows of a gradient with row stride
// rs, through a per-warp staging tile; rows past nrows and columns past D
// are dropped
__device__ __forceinline__ void store_grad_tile(bf16* dst, int rs, const FragC& acc,
                                                float* stage, int row0, int nrows, int d0,
                                                int D, int lane) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int row = row0 + e / 16, d = d0 + e % 16;
    if (row < nrows && d < D) dst[(long long)row * rs + d] = __float2bfloat16(stage[e]);
  }
  __syncwarp();
}

template <int DP, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LDQ = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * LDQ;
  bf16* Ks = dOs + kBQ * LDQ;
  bf16* Vs = Ks + kBKV * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + kBKV * LDQ);
  float* dPs = Ss + kWarps * 16 * kLDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + kWarps * 16 * kLDS);
  float* lse_s = reinterpret_cast<float*>(dSs + kWarps * 16 * kLDP);
  float* delta_s = lse_s + 64;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int nb = n / a.m, nj = n % a.m;
  const int D = a.head_dim;
  const long long hoff = (long long)h * D;
  const long long stat = ((long long)n * a.heads + h) * a.lq;

  load_rows<DP, kThreads>(
      Qs, a.q + (HEAD_MAJOR ? n * a.q_so + h * a.q_hs : nb * a.q_so + nj * a.q_si + hoff),
      HEAD_MAJOR ? D : a.hd, q0, a.lq, D);
  load_rows<DP, kThreads>(
      dOs,
      a.dout + (HEAD_MAJOR ? n * a.do_so + h * a.do_hs : nb * a.do_so + nj * a.do_si + hoff),
      HEAD_MAJOR ? D : a.hd, q0, a.lq, D);
  load_rows<DP, kThreads>(
      Ks, a.out + (HEAD_MAJOR ? n * a.o_so + h * a.o_hs : nb * a.o_so + nj * a.o_si + hoff),
      HEAD_MAJOR ? D : a.hd, q0, a.lq, D);
  __syncthreads();
  // delta = rowsum(dout * out) of this warp's 16 rows; lse in base-2 units,
  // +inf for rows past Lq so that their recomputed probabilities are 0
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r;
    float s = 0.0f;
    for (int d = lane; d < DP; d += 32)
      s += __bfloat162float(dOs[lr * LDQ + d]) * __bfloat162float(Ks[lr * LDQ + d]);
    s = warp_sum(s);
    if (lane == 0) {
      const int row = q0 + lr;
      delta_s[lr] = s;
      lse_s[lr] = row < a.lq ? a.lse[stat + row] * kLog2e : INFINITY;
      if (row < a.lq) a.delta[stat + row] = s;
    }
  }

  float* Sw = Ss + warp * 16 * kLDS;
  float* dPw = dPs + warp * 16 * kLDS;
  bf16* dSw = dSs + warp * 16 * kLDP;
  FragC acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

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
      __syncthreads();  // the previous tile's K/V (first: the out tile) are done with
      load_rows<DP, kThreads>(Ks, kb, HEAD_MAJOR ? D : a.hd, kv0, lkv, D);
      load_rows<DP, kThreads>(Vs, vb, HEAD_MAJOR ? D : a.hd, kv0, lkv, D);
      __syncthreads();

      // S = Q K^T and dP = dO V^T for this warp's 16 query rows
#pragma unroll
      for (int j = 0; j < kBKV / 16; ++j) {
        FragC cs, cp;
        wmma::fill_fragment(cs, 0.0f);
        wmma::fill_fragment(cp, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          FragA fa;
          FragBCol fb;
          wmma::load_matrix_sync(fa, Qs + warp * 16 * LDQ + kk * 16, LDQ);
          wmma::load_matrix_sync(fb, Ks + j * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(cs, fa, fb, cs);
          wmma::load_matrix_sync(fa, dOs + warp * 16 * LDQ + kk * 16, LDQ);
          wmma::load_matrix_sync(fb, Vs + j * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(cp, fa, fb, cp);
        }
        wmma::store_matrix_sync(Sw + j * 16, cs, kLDS, wmma::mem_row_major);
        wmma::store_matrix_sync(dPw + j * 16, cp, kLDS, wmma::mem_row_major);
      }
      __syncwarp();

      // dS = P * (dP - delta) * scale, P = exp2(S - lse)
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float l2 = lse_s[warp * 16 + r], dl = delta_s[warp * 16 + r];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;
          const int col = kv0 + c;
          float ds = 0.0f;
          if (col < lkv) {
            float s2 = Sw[r * kLDS + c] * a.scale_log2;
            if (bias != nullptr) s2 += bias[col] * kLog2e;
            ds = exp2f(s2 - l2) * (dPw[r * kLDS + c] - dl) * a.scale;
          }
          dSw[r * kLDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      // dQ += dS K
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk) {
          FragA fa;
          FragBRow fb;
          wmma::load_matrix_sync(fa, dSw + kk * 16, kLDP);
          wmma::load_matrix_sync(fb, Ks + kk * 16 * LDQ + j * 16, LDQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncwarp();
    }
  }

  bf16* dqb = a.dq + (HEAD_MAJOR ? ((long long)n * a.heads + h) * a.lq * D
                                 : (long long)n * a.lq * a.hd + hoff);
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    store_grad_tile(dqb, HEAD_MAJOR ? D : a.hd, acc[j], Sw, q0 + warp * 16, a.lq, j * 16, D,
                    lane);
}

// seg 0: blockIdx.z is the batch element whose K0/V0 tile this block owns,
// and the m query groups that shared it are walked in order; seg 1:
// blockIdx.z is the query group n. DBIAS (seg 0 only): also this head's
// share of dbias0 for the block's 64 columns, into a.dbias_part.
template <int DP, bool DBIAS, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs a, const int seg) {
  constexpr int LDQ = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * LDQ;
  bf16* Ks = dOs + kBQ * LDQ;
  bf16* Vs = Ks + kBKV * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + kBKV * LDQ);
  float* dPs = Ss + kWarps * 16 * kLDS;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + kWarps * 16 * kLDS);
  bf16* dSs = Ps + kWarps * 16 * kLDP;
  float* lse_s = reinterpret_cast<float*>(dSs + kWarps * 16 * kLDP);
  float* delta_s = lse_s + 64;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv0 = blockIdx.x * kBKV;
  const int h = blockIdx.y;
  const int owner = blockIdx.z;
  const int D = a.head_dim;
  const long long hoff = (long long)h * D;

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
  load_rows<DP, kThreads>(Ks, kb, HEAD_MAJOR ? D : a.hd, kv0, lkv, D);
  load_rows<DP, kThreads>(Vs, vb, HEAD_MAJOR ? D : a.hd, kv0, lkv, D);

  float* Sw = Ss + warp * 16 * kLDS;
  float* dPw = dPs + warp * 16 * kLDS;
  bf16* Pw = Ps + warp * 16 * kLDP;
  bf16* dSw = dSs + warp * 16 * kLDP;
  FragC accK[DP / 16], accV[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    wmma::fill_fragment(accK[j], 0.0f);
    wmma::fill_fragment(accV[j], 0.0f);
  }
  float db = 0.0f;  // DBIAS: lane r < 16 keeps the dbias sum of this warp's KV row r

  for (int n = n_first; n < n_first + n_count; ++n) {
    const int nb = n / a.m, nj = n % a.m;
    const bf16* qb =
        a.q + (HEAD_MAJOR ? n * a.q_so + h * a.q_hs : nb * a.q_so + nj * a.q_si + hoff);
    const bf16* dob =
        a.dout + (HEAD_MAJOR ? n * a.do_so + h * a.do_hs : nb * a.do_so + nj * a.do_si + hoff);
    const long long stat = ((long long)n * a.heads + h) * a.lq;
    for (int q0 = 0; q0 < a.lq; q0 += kBQ) {
      __syncthreads();  // the previous query tile is done with
      load_rows<DP, kThreads>(Qs, qb, HEAD_MAJOR ? D : a.hd, q0, a.lq, D);
      load_rows<DP, kThreads>(dOs, dob, HEAD_MAJOR ? D : a.hd, q0, a.lq, D);
      if (threadIdx.x < 64) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.lq ? a.lse[stat + row] * kLog2e : INFINITY;
        delta_s[threadIdx.x] = row < a.lq ? a.delta[stat + row] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 KV rows
#pragma unroll
      for (int j = 0; j < kBQ / 16; ++j) {
        FragC cs, cp;
        wmma::fill_fragment(cs, 0.0f);
        wmma::fill_fragment(cp, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          FragA fa;
          FragBCol fb;
          wmma::load_matrix_sync(fa, Ks + warp * 16 * LDQ + kk * 16, LDQ);
          wmma::load_matrix_sync(fb, Qs + j * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(cs, fa, fb, cs);
          wmma::load_matrix_sync(fa, Vs + warp * 16 * LDQ + kk * 16, LDQ);
          wmma::load_matrix_sync(fb, dOs + j * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(cp, fa, fb, cp);
        }
        wmma::store_matrix_sync(Sw + j * 16, cs, kLDS, wmma::mem_row_major);
        wmma::store_matrix_sync(dPw + j * 16, cp, kLDS, wmma::mem_row_major);
      }
      __syncwarp();

#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int col = kv0 + warp * 16 + r;  // this KV row
        const bool valid = col < lkv;
        const float b2 = (valid && bias != nullptr) ? bias[col] * kLog2e : 0.0f;
        float row_ds = 0.0f;  // this KV row's ds in natural units, this lane's two query rows
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;  // query row within the tile
          float p = 0.0f;
          if (valid) p = exp2f(Sw[r * kLDS + c] * a.scale_log2 + b2 - lse_s[c]);
          const float ds_nat = p * (dPw[r * kLDS + c] - delta_s[c]);
          const float ds = ds_nat * a.scale;
          if (DBIAS) row_ds += ds_nat;
          Pw[r * kLDP + c] = __float2bfloat16(p);
          dSw[r * kLDP + c] = __float2bfloat16(ds);
        }
        if (DBIAS) {
          row_ds = warp_sum(row_ds);
          if (lane == r) db += row_ds;
        }
      }
      __syncwarp();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
          FragA fa;
          FragBRow fb;
          wmma::load_matrix_sync(fa, Pw + kk * 16, kLDP);
          wmma::load_matrix_sync(fb, dOs + kk * 16 * LDQ + j * 16, LDQ);
          wmma::mma_sync(accV[j], fa, fb, accV[j]);
          wmma::load_matrix_sync(fa, dSw + kk * 16, kLDP);
          wmma::load_matrix_sync(fb, Qs + kk * 16 * LDQ + j * 16, LDQ);
          wmma::mma_sync(accK[j], fa, fb, accK[j]);
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    store_grad_tile(dkb, HEAD_MAJOR ? D : a.hd, accK[j], Sw, kv0 + warp * 16, lkv, j * 16, D,
                    lane);
    store_grad_tile(dvb, HEAD_MAJOR ? D : a.hd, accV[j], Sw, kv0 + warp * 16, lkv, j * 16, D,
                    lane);
  }
  if (DBIAS && lane < 16) {
    const int col = kv0 + warp * 16 + lane;
    if (col < lkv) a.dbias_part[((long long)owner * a.heads + h) * lkv + col] = db;
  }
}

// dq pass, then the dkv pass per segment; a non-null dbias_part selects the
// DBIAS instantiation of the segment-0 pass
template <int DP, bool HEAD_MAJOR>
int launch_bwd(const BwdArgs& a, int n_total, cudaStream_t stream) {
  const size_t smem_dq = bwd_smem_bytes<DP>(1), smem_dkv = bwd_smem_bytes<DP>(2);
  void (*dkv)(const BwdArgs, int) = flash_bwd_dkv_kernel<DP, false, HEAD_MAJOR>;
  void (*dkv0)(const BwdArgs, int) = dkv;
  if constexpr (!HEAD_MAJOR) {
    if (a.dbias_part != nullptr) dkv0 = flash_bwd_dkv_kernel<DP, true, false>;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, HEAD_MAJOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  if (dkv0 != dkv) {
    err = cudaFuncSetAttribute(dkv0, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((a.lq + kBQ - 1) / kBQ, a.heads, n_total);
  flash_bwd_dq_kernel<DP, HEAD_MAJOR><<<grid_q, kThreads, smem_dq, stream>>>(a);
  const dim3 grid_0((a.lkv0 + kBKV - 1) / kBKV, a.heads, n_total / a.m);
  dkv0<<<grid_0, kThreads, smem_dkv, stream>>>(a, 0);
  if (!HEAD_MAJOR && a.k1 != nullptr) {
    const dim3 grid_1((a.lkv1 + kBKV - 1) / kBKV, a.heads, n_total);
    dkv<<<grid_1, kThreads, smem_dkv, stream>>>(a, 1);
  }
  return (int)cudaGetLastError();
}

// head_dim -> the instantiation padded to the next multiple of 16
template <bool HEAD_MAJOR>
int dispatch_bwd(const BwdArgs& a, int n_total, cudaStream_t stream) {
  switch ((a.head_dim + 15) / 16) {
    case 1: return launch_bwd<16, HEAD_MAJOR>(a, n_total, stream);
    case 2: return launch_bwd<32, HEAD_MAJOR>(a, n_total, stream);
    case 3: return launch_bwd<48, HEAD_MAJOR>(a, n_total, stream);
    case 4: return launch_bwd<64, HEAD_MAJOR>(a, n_total, stream);
    case 5: return launch_bwd<80, HEAD_MAJOR>(a, n_total, stream);
    case 6: return launch_bwd<96, HEAD_MAJOR>(a, n_total, stream);
    case 7: return launch_bwd<112, HEAD_MAJOR>(a, n_total, stream);
    case 8: return launch_bwd<128, HEAD_MAJOR>(a, n_total, stream);
    case 9: return launch_bwd<144, HEAD_MAJOR>(a, n_total, stream);
    case 10: return launch_bwd<160, HEAD_MAJOR>(a, n_total, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace e2v

// flash_f32 backward: dq, dk0, dv0, dk1, dv1 and dbias0 of the f32 forward
// from its operands, out, lse and the output's gradient. See flash_f32.cuh
// for what it replaces and its design (3xTF32 on mma.sync).
//
//   p = exp(scale q k^T + bias - lse), delta = rowsum(dout * out),
//   dp = dout v^T, ds = p (dp - delta) scale,
//   dq = ds k, dk = ds^T q, dv = p^T dout, dbias0 = sum of ds / scale
//   over the m groups, the heads and the query rows on segment 0's columns.
//
// What bounds it on the H100: 10 Lq Lkv D operations a head (the scores
// twice, dp twice, dq, dk, dv: the split form recomputes the scores and dp
// in the second pass), as 3 tf32 products each at 494.7 TFLOP/s. Three
// passes, no atomics:
//   dq pass : a block owns 16 query rows a warp, Q and dO split once into
//             shared memory (and delta computed from them on the way); K and
//             V stream in tiles (64 rows, 32 from D = 56, 16 from D = 104),
//             each split once; per tile S = Q K^T and dP = dO V^T in C
//             fragments, dS = P (dP - delta) scale in place, dQ += dS K with
//             K read as stored (k along its rows).
//   dkv pass: per segment; a block owns 16 key rows a warp, K and V split
//             once; Q, dO, lse and delta stream in tiles of the same heights;
//             S^T = K Q^T and dP^T = V dO^T put keys on the rows, so P^T and
//             dS^T are A fragments of dV += P^T dO and dK += dS^T Q. Segment
//             0's blocks walk the m groups of their batch element in order
//             and write dbias0 per head.
//   dbias   : the head-order sum of the partials.
#include "flash_f32.cuh"

namespace e2v {
namespace f32k {
namespace {

// Q and dO (big and small, 16 rows a warp), the K and V landing tiles, their
// split tiles, the bias landing and split rows
template <int DP>
size_t dq_smem(int warps) {
  constexpr int LD = tile_ld<DP>(), BK = bwd_tile_rows<DP>();
  return ((size_t)4 * 16 * warps * LD + (size_t)6 * BK * LD + 2 * BK) * sizeof(float);
}

// K and V (big and small, 16 rows a warp), the Q and dO landing tiles, their
// split tiles, lse and delta landing and split rows
template <int DP>
size_t dkv_smem(int warps) {
  constexpr int LD = tile_ld<DP>(), BQ = bwd_tile_rows<DP>();
  return ((size_t)4 * 16 * warps * LD + (size_t)6 * BQ * LD + 4 * BQ) * sizeof(float);
}

// the threads' lanes of one warp split its own 16 rows of (big, small), which
// landed in small
template <int DP>
__device__ __forceinline__ void split_own_rows(float* big, float* small, int warp, int lane) {
  constexpr int LD = tile_ld<DP>();
  split_rows<DP>(big + warp * 16 * LD, small + warp * 16 * LD, small + warp * 16 * LD, 16, lane,
                 32);
}

// dq pass: a block owns 16 query rows a warp of (n, h); writes dq and delta
template <int DP>
__global__ void __launch_bounds__(256) flash_f32_dq_kernel(const AttnArgs a) {
  constexpr int LD = tile_ld<DP>(), NT = DP / 8, BK = bwd_tile_rows<DP>();
  constexpr int KC = BK < 32 ? BK : 32;  // KV columns of a score chunk
  extern __shared__ __align__(16) float sm[];
  const int bq = blockDim.x / 2;
  float* Qb = sm;
  float* Qs = Qb + bq * LD;
  float* Ob = Qs + bq * LD;  // dO
  float* Os = Ob + bq * LD;
  float* Rk = Os + bq * LD;
  float* Rv = Rk + BK * LD;
  float* Kb = Rv + BK * LD;
  float* Ks = Kb + BK * LD;
  float* Vb = Ks + BK * LD;
  float* Vs = Vb + BK * LD;
  float* Rb = Vs + BK * LD;
  float* Bs = Rb + BK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * bq, h = blockIdx.y, n = blockIdx.z;
  const int D = a.D;
  const bool vec = a.vec != 0;
  const long long stat = ((long long)n * a.H + h) * a.Lq;
  const float* bias = a.bias != nullptr ? a.bias + (long long)(n / a.m) * a.L0 : nullptr;
  const int t0n = (a.L0 + BK - 1) / BK;
  const int tn = t0n + (a.L1 + BK - 1) / BK;
  const float* kb0 = a.k0.at(n, a.m, h);
  const float* vb0 = a.v0.at(n, a.m, h);
  const float* kb1 = a.L1 > 0 ? a.k1.at(n, a.m, h) : nullptr;
  const float* vb1 = a.L1 > 0 ? a.v1.at(n, a.m, h) : nullptr;

  auto issue = [&](int t) {
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * BK, L = s1 ? a.L1 : a.L0;
    land_rows<DP>(Rk, s1 ? kb1 : kb0, s1 ? a.k1.sr : a.k0.sr, kv0, BK, L, D, vec);
    land_rows<DP>(Rv, s1 ? vb1 : vb0, s1 ? a.v1.sr : a.v0.sr, kv0, BK, L, D, vec);
    if (bias != nullptr && !s1) copy_floats(Rb, bias, kv0, BK, a.L0);
    cp_async_commit();
  };
  land_rows<DP>(Qs, a.q.at(n, a.m, h), a.q.sr, q0, bq, a.Lq, D, vec);
  land_rows<DP>(Os, a.dout.at(n, a.m, h), a.dout.sr, q0, bq, a.Lq, D, vec);
  issue(0);  // one group with Q and dO
  cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dout * out) of the warp's 16 rows, from dO as it landed
  // (before the split) and out from device memory; lse in base-2 units, +inf
  // for rows past Lq so that their recomputed probabilities are 0
  const float* orow = a.o.at(n, a.m, h);
  float dl[2] = {0.0f, 0.0f}, l2[2];
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float sum = 0.0f;
    if (row < a.Lq)
      for (int d = lane; d < D; d += 32)
        sum += Os[(warp * 16 + r) * LD + d] * orow[(long long)row * a.o.sr + d];
    sum = warp_sum(sum);
    if (r == g) dl[0] = sum;
    if (r == g + 8) dl[1] = sum;
    if (lane == 0 && row < a.Lq) a.delta[stat + row] = sum;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    l2[r] = row < a.Lq ? a.lse[stat + row] * kLog2e : INFINITY;
  }
  __syncwarp();
  split_own_rows<DP>(Qb, Qs, warp, lane);
  split_own_rows<DP>(Ob, Os, warp, lane);
  __syncwarp();

  const bool active = q0 + warp * 16 < a.Lq;
  const float sl2 = a.scale * kLog2e;
  const float* Qbw = Qb + warp * 16 * LD;
  const float* Qsw = Qs + warp * 16 * LD;
  const float* Obw = Ob + warp * 16 * LD;
  const float* Osw = Os + warp * 16 * LD;
  float acc[NT][4];
  zero(acc);

  for (int t = 0; t < tn; ++t) {
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * BK, L = s1 ? a.L1 : a.L0;
    const bool biased = bias != nullptr && !s1;
    cp_async_wait<0>();
    __syncthreads();
    split_rows<DP>(Kb, Ks, Rk, BK, threadIdx.x, blockDim.x);
    split_rows<DP>(Vb, Vs, Rv, BK, threadIdx.x, blockDim.x);
    if (biased)
      for (int i = threadIdx.x; i < BK; i += blockDim.x) Bs[i] = Rb[i] * kLog2e;
    __syncthreads();
    if (t + 1 < tn) issue(t + 1);
    if (!active) continue;
    const bool tail = kv0 + BK > L;

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KC) {
      if (tail && kv0 + c0 >= L) continue;  // P is 0 past the segment's end
      float s[KC / 8][4], dp[KC / 8][4];
      zero(s);
      zero(dp);
      mma_rows<DP, KC / 8>(s, Qbw, Qsw, Kb, Ks, c0, lane);   // S = Q K^T
      mma_rows<DP, KC / 8>(dp, Obw, Osw, Vb, Vs, c0, lane);  // dP = dO V^T
      // dS = P (dP - delta) scale, P = exp2(S scale log2(e) + bias - lse)
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * tq + (e & 1), r = e >> 1;
          float v = s[j][e] * sl2;
          if (biased) v += Bs[c];
          float p = exp2f(v - l2[r]);
          if (tail && kv0 + c >= L) p = 0.0f;
          s[j][e] = p * (dp[j][e] - dl[r]) * a.scale;
        }
      mma_c_by_cols<DP, KC / 8>(acc, s, Kb, Ks, c0, lane);  // dQ += dS K
    }
  }
  if (!active) return;
  const float one[2] = {1.0f, 1.0f};
  store_rows<DP>(a.dq.at(n, a.m, h), a.dq.sr, acc, one, q0 + warp * 16, a.Lq, D, vec, lane);
}

// dkv pass of segment SEG: a block owns 16 key rows a warp of (z, h), z the
// batch element (segment 0, shared by its m groups) or the query group
// (segment 1)
template <int DP, int SEG>
__global__ void __launch_bounds__(256, 1) flash_f32_dkv_kernel(const AttnArgs a) {
  constexpr int LD = tile_ld<DP>(), NT = DP / 8, BQ = bwd_tile_rows<DP>();
  constexpr int QC = BQ < 32 ? BQ : 32;  // query columns of a score chunk
  extern __shared__ __align__(16) float sm[];
  const int bk = blockDim.x / 2;
  float* Kb = sm;
  float* Ks = Kb + bk * LD;
  float* Vb = Ks + bk * LD;
  float* Vs = Vb + bk * LD;
  float* Rq = Vs + bk * LD;
  float* Ro = Rq + BQ * LD;
  float* Qb = Ro + BQ * LD;
  float* Qs = Qb + BQ * LD;
  float* Ob = Qs + BQ * LD;  // dO
  float* Os = Ob + BQ * LD;
  float* Rl = Os + BQ * LD;  // lse, delta as landed
  float* Rd = Rl + BQ;
  float* Ls = Rd + BQ;       // lse in base-2 units, +inf past Lq
  float* Ds = Ls + BQ;       // delta, 0 past Lq

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int kv0 = blockIdx.x * bk, h = blockIdx.y, z = blockIdx.z;
  const int D = a.D;
  const bool vec = a.vec != 0;
  const int L = SEG == 0 ? a.L0 : a.L1;
  const Tens& kt = SEG == 0 ? a.k0 : a.k1;
  const Tens& vt = SEG == 0 ? a.v0 : a.v1;
  // segment 0: groups z m .. z m + m - 1; segment 1: group z alone
  const int n_first = SEG == 0 ? z * a.m : z, n_count = SEG == 0 ? a.m : 1;
  const int b = n_first / a.m;
  const int nqt = (a.Lq + BQ - 1) / BQ;
  const int tn = n_count * nqt;  // query tiles of every group, in order

  auto issue = [&](int t) {
    const int n = n_first + t / nqt, q0 = (t % nqt) * BQ;
    const long long stat = ((long long)n * a.H + h) * a.Lq;
    land_rows<DP>(Rq, a.q.at(n, a.m, h), a.q.sr, q0, BQ, a.Lq, D, vec);
    land_rows<DP>(Ro, a.dout.at(n, a.m, h), a.dout.sr, q0, BQ, a.Lq, D, vec);
    copy_floats(Rl, a.lse + stat, q0, BQ, a.Lq);
    copy_floats(Rd, a.delta + stat, q0, BQ, a.Lq);
    cp_async_commit();
  };
  land_rows<DP>(Ks, kt.at(n_first, a.m, h), kt.sr, kv0, bk, L, D, vec);
  land_rows<DP>(Vs, vt.at(n_first, a.m, h), vt.sr, kv0, bk, L, D, vec);
  issue(0);  // one group with K and V
  cp_async_wait<0>();
  __syncthreads();
  split_own_rows<DP>(Kb, Ks, warp, lane);
  split_own_rows<DP>(Vb, Vs, warp, lane);
  __syncwarp();

  // bias of the thread's two key rows (g + 8 r), base 2
  float b2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = kv0 + warp * 16 + g + 8 * r;
    b2[r] = (SEG == 0 && a.bias != nullptr && c < L) ? a.bias[(long long)b * L + c] * kLog2e
                                                     : 0.0f;
  }
  const bool active = kv0 + warp * 16 < L;  // else the warp's rows all lie past L
  const float sl2 = a.scale * kLog2e;
  const float* Kbw = Kb + warp * 16 * LD;
  const float* Ksw = Ks + warp * 16 * LD;
  const float* Vbw = Vb + warp * 16 * LD;
  const float* Vsw = Vs + warp * 16 * LD;
  float dk[NT][4], dv[NT][4], db[2] = {0.0f, 0.0f};  // db: this lane's share of its rows' sums
  zero(dk);
  zero(dv);

  for (int t = 0; t < tn; ++t) {
    const int q0 = (t % nqt) * BQ;
    cp_async_wait<0>();
    __syncthreads();
    split_rows<DP>(Qb, Qs, Rq, BQ, threadIdx.x, blockDim.x);
    split_rows<DP>(Ob, Os, Ro, BQ, threadIdx.x, blockDim.x);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const bool in = q0 + i < a.Lq;
      Ls[i] = in ? Rl[i] * kLog2e : INFINITY;
      Ds[i] = in ? Rd[i] : 0.0f;
    }
    __syncthreads();
    if (t + 1 < tn) issue(t + 1);
    if (!active) continue;
    const bool tail = q0 + BQ > a.Lq;

#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      if (tail && q0 + c0 >= a.Lq) continue;  // P is 0 past Lq
      float s[QC / 8][4], dp[QC / 8][4];
      zero(s);
      zero(dp);
      mma_rows<DP, QC / 8>(s, Kbw, Ksw, Qb, Qs, c0, lane);   // S^T = K Q^T
      mma_rows<DP, QC / 8>(dp, Vbw, Vsw, Ob, Os, c0, lane);  // dP^T = V dO^T
      // P^T and dS^T; query columns past Lq give 0 (their lse is +inf)
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * tq + (e & 1), r = e >> 1;
          const float p = exp2f(fmaf(s[j][e], sl2, b2[r]) - Ls[c]);
          const float ds = p * (dp[j][e] - Ds[c]);
          if (SEG == 0) db[r] += ds;
          s[j][e] = p;
          dp[j][e] = ds * a.scale;
        }
      mma_c_by_cols<DP, QC / 8>(dv, s, Ob, Os, c0, lane);   // dV += P^T dO
      mma_c_by_cols<DP, QC / 8>(dk, dp, Qb, Qs, c0, lane);  // dK += dS^T Q
    }
  }
  if (!active) return;
  const Tens& dkt = SEG == 0 ? a.dk0 : a.dk1;
  const Tens& dvt = SEG == 0 ? a.dv0 : a.dv1;
  const float one[2] = {1.0f, 1.0f};
  store_rows<DP>(dkt.at(n_first, a.m, h), dkt.sr, dk, one, kv0 + warp * 16, L, D, vec, lane);
  store_rows<DP>(dvt.at(n_first, a.m, h), dvt.sr, dv, one, kv0 + warp * 16, L, D, vec, lane);
  if (SEG == 0 && a.dbias_part != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = db[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int c = kv0 + warp * 16 + g + 8 * r;
      if (tq == 0 && c < L) a.dbias_part[((long long)b * a.H + h) * L + c] = v;
    }
  }
}

// dbias0[b, c] = sum over the heads, in order, of the partials
__global__ void flash_f32_dbias_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int B, int H, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * L) return;
  const long long b = i / L, c = i % L;
  float s = 0.0f;
  for (int h = 0; h < H; ++h) s += part[(b * H + h) * L + c];
  out[i] = s;
}

template <int DP>
struct LaunchBwd {
  static int run(const AttnArgs& a, cudaStream_t stream) {
    auto* dq = flash_f32_dq_kernel<DP>;
    const int wq = pick_warps(dq, dq_smem<DP>, a.Lq, a.H * a.N);
    if (wq == 0) return (int)cudaErrorInvalidValue;
    dq<<<dim3((a.Lq + 16 * wq - 1) / (16 * wq), a.H, a.N), 32 * wq, dq_smem<DP>(wq), stream>>>(
        a);
    int rc = launch_dkv<0>(a, a.L0, a.N / a.m, stream);
    if (rc != 0 || a.L1 == 0) return rc;
    return launch_dkv<1>(a, a.L1, a.N, stream);
  }
  template <int SEG>
  static int launch_dkv(const AttnArgs& a, int L, int owners, cudaStream_t stream) {
    auto* kernel = flash_f32_dkv_kernel<DP, SEG>;
    const int w = pick_warps(kernel, dkv_smem<DP>, L, a.H * owners);
    if (w == 0) return (int)cudaErrorInvalidValue;
    kernel<<<dim3((L + 16 * w - 1) / (16 * w), a.H, owners), 32 * w, dkv_smem<DP>(w), stream>>>(
        a);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace f32k
}  // namespace e2v

// ptrs: q, k0, v0, k1, v1, dout, out, dq, dk0, dv0, dk1, dv1 (the segment-1
// ones null without it), lse (N, H, Lq), delta (N, H, Lq) scratch, bias0
// (b, L0) or null, dbias_part (b, H, L0) and dbias (b, L0) or null; all f32.
// strides: (sb, sg, sh, sr) of the twelve tensors in that order (48).
// dims: N, m, Lq, L0, L1, H, D. Returns the launch status.
extern "C" int e2v_flash_f32_bwd(const void* const* ptrs, const long long* strides,
                                 const int* dims, float scale, void* stream) {
  using namespace e2v::f32k;
  AttnArgs a = {};
  Tens* ts[12] = {&a.q, &a.k0, &a.v0, &a.k1, &a.v1, &a.dout,
                  &a.o, &a.dq, &a.dk0, &a.dv0, &a.dk1, &a.dv1};
  for (int i = 0; i < 12; ++i) *ts[i] = tens(ptrs[i], strides + 4 * i);
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[12]));
  a.delta = static_cast<float*>(const_cast<void*>(ptrs[13]));
  a.bias = static_cast<const float*>(ptrs[14]);
  a.dbias_part = static_cast<float*>(const_cast<void*>(ptrs[15]));
  a.dbias = static_cast<float*>(const_cast<void*>(ptrs[16]));
  a.N = dims[0], a.m = dims[1], a.Lq = dims[2], a.L0 = dims[3], a.L1 = dims[4];
  a.H = dims[5], a.D = dims[6];
  a.scale = scale;
  if (a.D % 8 != 0 || a.D < 8 || a.D > kMaxD || a.m < 1 || a.N % a.m != 0)
    return (int)cudaErrorInvalidValue;
  if (a.N == 0 || a.Lq == 0) return 0;
  if (a.k1.p == nullptr) a.L1 = 0;
  a.vec = rows16(ts, 12);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = dispatch_dp<LaunchBwd>(a.D, a, s);
  if (rc != 0 || a.dbias == nullptr) return rc;
  const int B = a.N / a.m, threads = 256;
  const long long total = (long long)B * a.L0;
  flash_f32_dbias_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      a.dbias_part, a.dbias, B, a.H, a.L0);
  return (int)cudaGetLastError();
}

// flash_f32 forward: softmax(scale q [K0 | K1]^T + [bias0 | 0]) [V0 | V1]
// per head on f32 operands, with the optional natural-log row lse. See
// flash_f32.cuh for what it replaces and its design (3xTF32 on mma.sync).
//
// What bounds it on the H100: 4 Lq Lkv D operations a head, as 3 tf32
// products each at 494.7 TFLOP/s; at the model's shapes far above the bytes
// of q, k, v and out. A block owns 16 query rows a warp; K and V stream in
// tiles of 64 rows (32 from D = 96), each split once into big and small
// tiles for all its warps; per chunk of 32 keys a warp forms S = Q K^T in C
// fragments, scales it to base 2 (with the bias), keeps the true running row
// max and sum, turns S into P in place and adds P V into O, all in
// registers.
#include "flash_f32.cuh"

namespace e2v {
namespace f32k {
namespace {

// Q (big and small, 16 rows a warp), the K and V landing tiles, their split
// tiles, the bias landing and split rows
template <int DP>
size_t fwd_smem(int warps) {
  constexpr int LD = tile_ld<DP>(), BK = fwd_kv_rows<DP>();
  return ((size_t)2 * 16 * warps * LD + (size_t)6 * BK * LD + 2 * BK) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(256, DP <= 48 ? 2 : 1) flash_f32_fwd_kernel(const AttnArgs a) {
  constexpr int LD = tile_ld<DP>(), NT = DP / 8, BK = fwd_kv_rows<DP>();
  constexpr int KC = 32;  // keys of a score chunk: S stays within 16 registers
  extern __shared__ __align__(16) float sm[];
  const int bq = blockDim.x / 2;  // 16 rows a warp
  float* Qb = sm;
  float* Qs = Qb + bq * LD;  // Q lands here and is split in place
  float* Rk = Qs + bq * LD;
  float* Rv = Rk + BK * LD;
  float* Kb = Rv + BK * LD;
  float* Ks = Kb + BK * LD;
  float* Vb = Ks + BK * LD;
  float* Vs = Vb + BK * LD;
  float* Rb = Vs + BK * LD;
  float* Bs = Rb + BK;  // bias log2(e), segment 0's tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int q0 = blockIdx.x * bq, h = blockIdx.y, n = blockIdx.z;
  const int D = a.D;
  const bool vec = a.vec != 0;
  const float* bias = a.bias != nullptr ? a.bias + (long long)(n / a.m) * a.L0 : nullptr;
  // KV tiles of both segments in one sequence: tiles [0, t0n) are segment 0
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
  issue(0);  // one group with Q

  const bool active = q0 + warp * 16 < a.Lq;  // else the warp's rows all lie past Lq
  const float sl2 = a.scale * kLog2e;
  const float* Qbw = Qb + warp * 16 * LD;
  const float* Qsw = Qs + warp * 16 * LD;
  float o[NT][4];
  zero(o);
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};

  for (int t = 0; t < tn; ++t) {
    const bool s1 = t >= t0n;
    const int kv0 = (s1 ? t - t0n : t) * BK, L = s1 ? a.L1 : a.L0;
    const bool biased = bias != nullptr && !s1;
    cp_async_wait<0>();  // tile t (and at t = 0, Q) has landed
    __syncthreads();     // ... for every thread; every warp is done with tile t-1
    if (t == 0) split_rows<DP>(Qb, Qs, Qs, bq, threadIdx.x, blockDim.x);
    split_rows<DP>(Kb, Ks, Rk, BK, threadIdx.x, blockDim.x);
    split_rows<DP>(Vb, Vs, Rv, BK, threadIdx.x, blockDim.x);
    if (biased)
      for (int i = threadIdx.x; i < BK; i += blockDim.x) Bs[i] = Rb[i] * kLog2e;
    __syncthreads();  // the split tiles are complete; the landing tiles are free
    if (t + 1 < tn) issue(t + 1);
    if (!active) continue;

    const bool tail = kv0 + BK > L;
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KC) {
      if (tail && kv0 + c0 >= L) continue;  // the chunk lies past the segment's end
      float s[KC / 8][4];
      zero(s);
      mma_rows<DP, KC / 8>(s, Qbw, Qsw, Kb, Ks, c0, lane);  // S = Q K^T
      // base-2 logits; keys past the segment's end (its last tile only) -inf
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * tq + (e & 1);
          float v = s[j][e] * sl2;
          if (biased) v += Bs[c];
          if (tail && kv0 + c >= L) v = -INFINITY;
          s[j][e] = v;
        }
      // online softmax, true running max; row r of the thread: g + 8 r
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[r], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(mrow[r] - m_use);
        mrow[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          s[j][2 * r] = exp2f(s[j][2 * r] - m_use);
          s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_use);
          sum += s[j][2 * r] + s[j][2 * r + 1];
        }
        lrow[r] = lrow[r] * alpha + sum;  // this lane's share of the row sum
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }
      mma_c_by_cols<DP, KC / 8>(o, s, Vb, Vs, c0, lane);  // O += P V
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  if (!active) return;
  const float inv[2] = {1.0f / lrow[0], 1.0f / lrow[1]};
  store_rows<DP>(a.o.at(n, a.m, h), a.o.sr, o, inv, q0 + warp * 16, a.Lq, D, vec, lane);
  if (a.lse != nullptr && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < a.Lq)
        a.lse[((long long)n * a.H + h) * a.Lq + row] = (mrow[r] + log2f(lrow[r])) * kLn2;
    }
  }
}

template <int DP>
struct LaunchFwd {
  static int run(const AttnArgs& a, cudaStream_t stream) {
    auto* kernel = flash_f32_fwd_kernel<DP>;
    const int w = pick_warps(kernel, fwd_smem<DP>, a.Lq, a.H * a.N);
    if (w == 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((a.Lq + 16 * w - 1) / (16 * w), a.H, a.N);
    kernel<<<grid, 32 * w, fwd_smem<DP>(w), stream>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace
}  // namespace f32k
}  // namespace e2v

// ptrs: q, k0, v0, k1, v1, out, bias0 (b, L0) or null, lse (N, H, Lq) or
// null, all f32. strides: (sb, sg, sh, sr) of q, k0, v0, k1, v1, out (24).
// dims: N, m, Lq, L0, L1, H, D; D % 8 == 0, D <= 160. Returns the launch status.
extern "C" int e2v_flash_f32_fwd(const void* const* ptrs, const long long* strides,
                                 const int* dims, float scale, void* stream) {
  using namespace e2v::f32k;
  AttnArgs a = {};
  a.q = tens(ptrs[0], strides);
  a.k0 = tens(ptrs[1], strides + 4);
  a.v0 = tens(ptrs[2], strides + 8);
  a.k1 = tens(ptrs[3], strides + 12);
  a.v1 = tens(ptrs[4], strides + 16);
  a.o = tens(ptrs[5], strides + 20);
  a.bias = static_cast<const float*>(ptrs[6]);
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[7]));
  a.N = dims[0], a.m = dims[1], a.Lq = dims[2], a.L0 = dims[3], a.L1 = dims[4];
  a.H = dims[5], a.D = dims[6];
  a.scale = scale;
  if (a.D % 8 != 0 || a.D < 8 || a.D > kMaxD || a.m < 1 || a.N % a.m != 0)
    return (int)cudaErrorInvalidValue;
  if (a.N == 0 || a.Lq == 0) return 0;
  if (a.k1.p == nullptr) a.L1 = 0;
  const Tens* ts[6] = {&a.q, &a.k0, &a.v0, &a.k1, &a.v1, &a.o};
  a.vec = rows16(ts, 6);
  return dispatch_dp<LaunchFwd>(a.D, a, static_cast<cudaStream_t>(stream));
}

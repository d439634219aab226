// flash_f32 backward: dq, dk0, dv0, dk1, dv1 and dbias0 of the f32 forward
// from its operands, out, lse and the output's gradient. See flash_f32.cuh.
//
//   p = exp(scale q k^T + bias - lse), delta = rowsum(dout * out),
//   dp = dout v^T, ds = p (dp - delta) scale,
//   dq = ds k, dk = ds^T q, dv = p^T dout, dbias0 = sum of ds / scale
//   over the m groups, the heads and the query rows on segment 0's columns.
//
// What bounds it on the H100: 10 Lq Lkv D operations a head (the scores
// twice, dp, dq, dk, dv) at the FP32 rate without tensor cores. Three
// passes, no atomics: dq (with delta), dkv per segment (segment 0's blocks
// walk the m groups of their batch element in order and write per-head
// dbias partials), then the head-order sum of the partials.
#include "flash_f32.cuh"

namespace e2v {
namespace f32k {
namespace {

// dq pass: a block owns 64 query rows of (n, h); writes dq and delta
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_f32_dq_kernel(const AttnArgs a) {
  constexpr int LD = DP + 1, NJ = DP / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Os = Qs + kTile * LD;  // dO
  float* Ks = Os + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // ds
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, n = blockIdx.z;
  const int b = n / a.m, t_y = ty(), t_x = tx();
  const long long row_base = ((long long)n * a.H + h) * a.Lq;

  load_tile<kTile, DP, LD>(Qs, a.q.at(n, a.m, h), a.q.sr, q0, a.Lq, 0, a.D);
  load_tile<kTile, DP, LD>(Os, a.dout.at(n, a.m, h), a.dout.sr, q0, a.Lq, 0, a.D);
  __syncthreads();
  // delta and lse of this thread's 4 rows (rows past Lq: 0 and +inf)
  float delta[4], lse[4];
  const float* orow = a.o.at(n, a.m, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * t_y + i;
    float part = 0.0f;
    if (q0 + r < a.Lq) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = t_x + 16 * j;
        if (d < a.D) part += Os[r * LD + d] * orow[(long long)(q0 + r) * a.o.sr + d];
      }
    }
    delta[i] = group_sum(part);
    lse[i] = q0 + r < a.Lq ? a.lse[row_base + q0 + r] : INFINITY;
    if (t_x == 0 && q0 + r < a.Lq) a.delta[row_base + q0 + r] = delta[i];
  }
  float dq[4][NJ];
  zero(dq);
  for (int seg = 0; seg < 2; ++seg) {
    const int L = seg == 0 ? a.L0 : a.L1;
    const Tens& kt = seg == 0 ? a.k0 : a.k1;
    const Tens& vt = seg == 0 ? a.v0 : a.v1;
    for (int kv0 = 0; kv0 < L; kv0 += kTile) {
      __syncthreads();
      load_tile<kTile, DP, LD>(Ks, kt.at(n, a.m, h), kt.sr, kv0, L, 0, a.D);
      load_tile<kTile, DP, LD>(Vs, vt.at(n, a.m, h), vt.sr, kv0, L, 0, a.D);
      __syncthreads();
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mm<4, 4, DP>(s, Qs, LD, 1, Ks, 1, LD);   // q k^T
      mm<4, 4, DP>(dp, Os, LD, 1, Vs, 1, LD);  // dout v^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kv0 + t_x + 16 * j;
        const float bias = (seg == 0 && a.bias != nullptr && c < L) ? a.bias[(long long)b * L + c]
                                                                  : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = c < L ? expf(s[i][j] * a.scale + bias - lse[i]) : 0.0f;
          Ps[(4 * t_y + i) * kLS + t_x + 16 * j] = p * (dp[i][j] - delta[i]) * a.scale;
        }
      }
      __syncthreads();
      mm<4, NJ, kTile>(dq, Ps, kLS, 1, Ks, LD, 1);  // ds k
    }
  }
  float* dqrow = a.dq.at(n, a.m, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * t_y + i;
    if (r >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = t_x + 16 * j;
      if (d < a.D) dqrow[(long long)r * a.dq.sr + d] = dq[i][j];
    }
  }
}

// dkv pass of segment SEG: a block owns 64 key rows of (z, h), z the batch
// element (segment 0, shared by its m groups) or the query group (segment 1)
template <int DP, int SEG>
__global__ void __launch_bounds__(kThreads) flash_f32_dkv_kernel(const AttnArgs a) {
  constexpr int LD = DP + 1, NJ = DP / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* Os = Qs + kTile * LD;  // dO
  float* Ps = Os + kTile * LD;  // p^T [key][query]
  float* Ds = Ps + kTile * kLS; // ds^T scale
  float* lse_s = Ds + kTile * kLS;
  float* delta_s = lse_s + kTile;
  const int kv0 = blockIdx.x * kTile, h = blockIdx.y, z = blockIdx.z;
  const int L = SEG == 0 ? a.L0 : a.L1;
  const Tens& kt = SEG == 0 ? a.k0 : a.k1;
  const Tens& vt = SEG == 0 ? a.v0 : a.v1;
  // segment 0: groups z m .. z m + m - 1; segment 1: group z alone
  const int n_first = SEG == 0 ? z * a.m : z, n_end = SEG == 0 ? n_first + a.m : z + 1;
  const int b = n_first / a.m, t_y = ty(), t_x = tx();

  load_tile<kTile, DP, LD>(Ks, kt.at(n_first, a.m, h), kt.sr, kv0, L, 0, a.D);
  load_tile<kTile, DP, LD>(Vs, vt.at(n_first, a.m, h), vt.sr, kv0, L, 0, a.D);
  float bias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = kv0 + 4 * t_y + i;
    bias[i] = (SEG == 0 && a.bias != nullptr && c < L) ? a.bias[(long long)b * L + c] : 0.0f;
  }
  float dk[4][NJ], dv[4][NJ], dbias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  zero(dk);
  zero(dv);
  for (int n = n_first; n < n_end; ++n) {
    const long long row_base = ((long long)n * a.H + h) * a.Lq;
    for (int q0 = 0; q0 < a.Lq; q0 += kTile) {
      __syncthreads();
      load_tile<kTile, DP, LD>(Qs, a.q.at(n, a.m, h), a.q.sr, q0, a.Lq, 0, a.D);
      load_tile<kTile, DP, LD>(Os, a.dout.at(n, a.m, h), a.dout.sr, q0, a.Lq, 0, a.D);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < a.Lq;
        lse_s[r] = in ? a.lse[row_base + q0 + r] : INFINITY;
        delta_s[r] = in ? a.delta[row_base + q0 + r] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mm<4, 4, DP>(s, Ks, LD, 1, Qs, 1, LD);   // (q k^T)^T: rows keys, columns queries
      mm<4, 4, DP>(dp, Vs, LD, 1, Os, 1, LD);  // (dout v^T)^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool key_in = kv0 + 4 * t_y + i < L;
        float row_ds = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = t_x + 16 * j;  // query row of the tile
          const float p = key_in ? expf(s[i][j] * a.scale + bias[i] - lse_s[c]) : 0.0f;
          const float ds = p * (dp[i][j] - delta_s[c]);
          row_ds += ds;
          Ps[(4 * t_y + i) * kLS + c] = p;
          Ds[(4 * t_y + i) * kLS + c] = ds * a.scale;
        }
        if (SEG == 0) dbias[i] += group_sum(row_ds);
      }
      __syncthreads();
      mm<4, NJ, kTile>(dv, Ps, kLS, 1, Os, LD, 1);  // p^T dout
      mm<4, NJ, kTile>(dk, Ds, kLS, 1, Qs, LD, 1);  // ds^T q
    }
  }
  const Tens& dkt = SEG == 0 ? a.dk0 : a.dk1;
  const Tens& dvt = SEG == 0 ? a.dv0 : a.dv1;
  float* dkrow = dkt.at(n_first, a.m, h);
  float* dvrow = dvt.at(n_first, a.m, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = kv0 + 4 * t_y + i;
    if (c >= L) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = t_x + 16 * j;
      if (d < a.D) {
        dkrow[(long long)c * dkt.sr + d] = dk[i][j];
        dvrow[(long long)c * dvt.sr + d] = dv[i][j];
      }
    }
    if (SEG == 0 && a.dbias_part != nullptr && t_x == 0)
      a.dbias_part[((long long)b * a.H + h) * L + c] = dbias[i];
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
    int rc = launch_dq(a, stream);
    if (rc != 0) return rc;
    rc = launch_dkv<0>(a, dim3((a.L0 + kTile - 1) / kTile, a.H, a.N / a.m), stream);
    if (rc != 0 || a.L1 == 0) return rc;
    return launch_dkv<1>(a, dim3((a.L1 + kTile - 1) / kTile, a.H, a.N), stream);
  }
  static int launch_dq(const AttnArgs& a, cudaStream_t stream) {
    const dim3 grid((a.Lq + kTile - 1) / kTile, a.H, a.N);
    E2V_LAUNCH(flash_f32_dq_kernel<DP>, grid, kThreads, dq_smem<DP>(), stream, a);
  }
  template <int SEG>
  static int launch_dkv(const AttnArgs& a, dim3 grid, cudaStream_t stream) {
    auto* kernel = flash_f32_dkv_kernel<DP, SEG>;
    E2V_LAUNCH(kernel, grid, kThreads, dkv_smem<DP>(), stream, a);
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
  if (a.D % 8 != 0 || a.D > kMaxD || a.m < 1 || a.N % a.m != 0) return (int)cudaErrorInvalidValue;
  if (a.N == 0 || a.Lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = dispatch_dp<LaunchBwd>(a.D, a, s);
  if (rc != 0 || a.dbias == nullptr) return rc;
  const int B = a.N / a.m, threads = 256;
  const long long total = (long long)B * a.L0;
  flash_f32_dbias_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      a.dbias_part, a.dbias, B, a.H, a.L0);
  return (int)cudaGetLastError();
}

// flash_f32 forward: softmax(scale q [K0 | K1]^T + [bias0 | 0]) [V0 | V1]
// per head on f32 operands, with the optional natural-log row lse. See
// flash_f32.cuh for what it replaces and its design.
//
// What bounds it on the H100: 4 Lq Lkv D operations a head at the FP32 rate
// without tensor cores (67 TFLOP/s); at the model's shapes that is far above
// the bytes of q, k, v and out. Per key tile a thread reads 4 + 4 scalars
// of shared memory for 16 FMAs of the scores and 4 + D / 16 for 4 D / 16 of
// P V, so the shared-memory loads set its pace, not the FMAs.
#include "flash_f32.cuh"

namespace e2v {
namespace f32k {
namespace {

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_f32_fwd_kernel(const AttnArgs a) {
  constexpr int LD = DP + 1, NJ = DP / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, n = blockIdx.z;
  const int b = n / a.m, t_y = ty(), t_x = tx();

  load_tile<kTile, DP, LD>(Qs, a.q.at(n, a.m, h), a.q.sr, q0, a.Lq, 0, a.D);
  float o[4][NJ], mrow[4], lrow[4];
  zero(o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.0f;
  }
  for (int seg = 0; seg < 2; ++seg) {
    const int L = seg == 0 ? a.L0 : a.L1;
    const Tens& kt = seg == 0 ? a.k0 : a.k1;
    const Tens& vt = seg == 0 ? a.v0 : a.v1;
    for (int kv0 = 0; kv0 < L; kv0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<kTile, DP, LD>(Ks, kt.at(n, a.m, h), kt.sr, kv0, L, 0, a.D);
      load_tile<kTile, DP, LD>(Vs, vt.at(n, a.m, h), vt.sr, kv0, L, 0, a.D);
      __syncthreads();
      float s[4][4];
      zero(s);
      mm<4, 4, DP>(s, Qs, LD, 1, Ks, 1, LD);  // S[r][c] = sum_d Q[r][d] K[c][d]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kv0 + t_x + 16 * j;
        const float bias = (seg == 0 && a.bias != nullptr && c < L) ? a.bias[(long long)b * L + c]
                                                                  : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = c < L ? s[i][j] * a.scale + bias : -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mx = group_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
        const float m_new = fmaxf(mrow[i], mx);
        const float shift = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = expf(mrow[i] - shift);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - shift);
          rs += s[i][j];
          Ps[(4 * t_y + i) * kLS + t_x + 16 * j] = s[i][j];
        }
        lrow[i] = lrow[i] * alpha + group_sum(rs);
        mrow[i] = m_new;
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
      }
      __syncthreads();
      mm<4, NJ, kTile>(o, Ps, kLS, 1, Vs, LD, 1);  // O[r][d] += sum_c P[r][c] V[c][d]
    }
  }
  float* orow = a.o.at(n, a.m, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * t_y + i;
    if (r >= a.Lq) continue;
    const float inv = 1.0f / lrow[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = t_x + 16 * j;
      if (d < a.D) orow[(long long)r * a.o.sr + d] = o[i][j] * inv;
    }
    if (a.lse != nullptr && t_x == 0)
      a.lse[((long long)n * a.H + h) * a.Lq + r] = mrow[i] + logf(lrow[i]);
  }
}

template <int DP>
struct LaunchFwd {
  static int run(const AttnArgs& a, cudaStream_t stream) {
    const dim3 grid((a.Lq + kTile - 1) / kTile, a.H, a.N);
    E2V_LAUNCH(flash_f32_fwd_kernel<DP>, grid, kThreads, fwd_smem<DP>(), stream, a);
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
  if (a.D % 8 != 0 || a.D > kMaxD || a.m < 1 || a.N % a.m != 0) return (int)cudaErrorInvalidValue;
  if (a.N == 0 || a.Lq == 0) return 0;
  return dispatch_dp<LaunchFwd>(a.D, a, static_cast<cudaStream_t>(stream));
}

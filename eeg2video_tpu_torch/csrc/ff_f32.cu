// ff_f32 / ff_f32_bwd: the f32 counterparts of ff_ln / ff_ln_bwd, the whole
// pre-LN GEGLU feed-forward block with its residual and its input gradient,
//   out = x + (h * gelu_erf(g)) Wo^T + bo,   [h | g] = LN(x) Wp^T + bp,
//   dx  = dout + rstd (dxn - mean(dxn) - xhat mean(dxn xhat)),
//         dxn = (dh2 Wp) gamma, dh2 = [dgated gelu(g) | dgated h gelu'(g)],
//         dgated = dout Wo.
//
// Replaces (JAX package, eeg2video_tpu/ops/geglu.py), where it runs on f32
// operands (fused_ff_ln tests no dtype, :407): _ff_pallas :242 (_ff_kernel
// :213) and _ff_bwd_pallas :324 (_ff_bwd_kernel :280).
//
// Any C % 8 == 0 up to 640, I % 32 == 0. All f32: loads, FMA, accumulation,
// erff / expf.
//
// What bounds it on the H100: 6 T C I operations forward and 10 T C I
// backward at the FP32 rate without tensor cores (67 TFLOP/s); the bytes of
// x, dout and out are three orders of magnitude smaller at the model's
// shapes. The (T, 2I) intermediate never reaches device memory.
//
// Design: a block owns BM token rows (32 forward, 16 backward) and all C
// columns, C padded to CP = 64 NS in shared memory (zeros past C):
//   - LayerNorm in the prologue, one warp per row, f32; the LN'd rows (and
//     in the backward the cotangent rows and each row's mu and rstd) stay in
//     shared memory for the block;
//   - the inner dimension is walked in 32-wide chunks: per chunk the (BM, 64)
//     [h | g] projection in 64-column k-slabs of Wp (its chunk's 32 h and 32
//     g rows), so that a thread holds h and g of the same columns and applies
//     the gate (forward) or its backward (dgated from the Wo chunk, then dh2)
//     in registers; the forward accumulates the (BM, C) output across chunks
//     in registers, the backward the (BM, C) dh2 Wp, its Wp slabs read again
//     after dh2 is known;
//   - every sum runs in one fixed order (chunks, slabs and k in order, row
//     reductions by xor-shuffles): no atomics, the same bits on every run.
#include "f32_tiles.cuh"

namespace e2v {
namespace f32k {
namespace {

constexpr int kChunk = 32;      // inner columns of a chunk (h and g: 64 rows of Wp)
constexpr int kSlab = 64;       // k-width of a Wp slab
constexpr int kLDW = kSlab + 1;
constexpr int kLDO = kChunk + 1;

template <int NS, int BM>
struct FfF32Shape {
  static constexpr int CP = 64 * NS;
  static constexpr int LDX = CP + 1;
  static constexpr int RM = BM / 16;
  static constexpr int NJ = CP / 16;
};

// LayerNorm of rows row0 .. row0 + BM - 1 into Xn (gamma, beta applied),
// zeros past C and past T; mu and rstd per row into mu_s / rstd_s if given
template <int BM, int CP, int LDX>
__device__ __forceinline__ void layer_norm_rows(float* Xn, const float* __restrict__ x,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int row0, int T,
                                                int C, float eps, float* mu_s, float* rstd_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = row0 + r;
    const float* xr = x + (long long)row * C;
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += row < T ? xr[c] : 0.0f;
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = row < T ? xr[c] - mu : 0.0f;
      sq += v * v;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    for (int c = lane; c < CP; c += 32)
      Xn[r * LDX + c] = (row < T && c < C) ? (xr[c] - mu) * rstd * gamma[c] + beta[c] : 0.0f;
    if (mu_s != nullptr && lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
}

// Wp slab: the chunk's 32 h rows (j0 ..) and 32 g rows (I + j0 ..), columns
// c0 .. c0 + 63 (zeros past C), as Ws[row][col]
__device__ __forceinline__ void load_wp_slab(float* Ws, const float* __restrict__ wp, int I,
                                             int C, int j0, int c0) {
  for (int i = threadIdx.x; i < 2 * kChunk * kSlab; i += kThreads) {
    const int r = i / kSlab, c = i % kSlab;
    const int src = r < kChunk ? j0 + r : I + j0 + r - kChunk;
    Ws[r * kLDW + c] = c0 + c < C ? wp[(long long)src * C + c0 + c] : 0.0f;
  }
}

// Wo chunk: all CP rows (zeros past C), columns j0 .. j0 + 31, as Wos[c][j]
template <int CP>
__device__ __forceinline__ void load_wo_chunk(float* Wos, const float* __restrict__ wo, int I,
                                              int C, int j0) {
  for (int i = threadIdx.x; i < CP * kChunk; i += kThreads) {
    const int c = i / kChunk, j = i % kChunk;
    Wos[c * kLDO + j] = c < C ? wo[(long long)c * I + j0 + j] : 0.0f;
  }
}

// [h | g] of the chunk for this thread's rows: h2[i][j], columns tx + 16 j of
// the chunk's 64 (j = 0, 1: h columns tx, tx + 16; j = 2, 3: the g columns
// of the same), k over the C columns in slabs
template <int RM, int NS, int LDX>
__device__ __forceinline__ void chunk_projection(float (&h2)[RM][4], const float* Xn, float* Ws,
                                                 const float* __restrict__ wp, int I, int C,
                                                 int j0) {
  zero(h2);
  for (int s = 0; s < NS; ++s) {
    __syncthreads();  // the slab's previous readers are done
    load_wp_slab(Ws, wp, I, C, j0, s * kSlab);
    __syncthreads();
    mm<RM, 4, kSlab>(h2, Xn + s * kSlab, LDX, 1, Ws, 1, kLDW);
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
    ff_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ wp,
                  const float* __restrict__ bp, const float* __restrict__ wo,
                  const float* __restrict__ bo, float* __restrict__ out, int T, int C, int I,
                  float eps) {
  using S = FfF32Shape<NS, 32>;
  constexpr int RM = S::RM, NJ = S::NJ, LDX = S::LDX;
  extern __shared__ float sm[];
  float* Xn = sm;                      // 32 x LDX
  float* Ws = Xn + 32 * LDX;           // 64 x kLDW
  float* Gs = Ws + 2 * kChunk * kLDW;  // 32 x kLDO, the gated chunk
  float* Wos = Gs + 32 * kLDO;         // CP x kLDO
  const int row0 = blockIdx.x * 32, t_y = ty(), t_x = tx();
  layer_norm_rows<32, S::CP, LDX>(Xn, x, gamma, beta, row0, T, C, eps, nullptr, nullptr);
  float acc[RM][NJ];
  zero(acc);
  for (int j0 = 0; j0 < I; j0 += kChunk) {
    float h2[RM][4];
    chunk_projection<RM, NS, LDX>(h2, Xn, Ws, wp, I, C, j0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = t_x + 16 * j;
      const float bh = bp[j0 + col], bg = bp[I + j0 + col];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        Gs[(RM * t_y + i) * kLDO + col] = (h2[i][j] + bh) * gelu_erf(h2[i][j + 2] + bg);
    }
    load_wo_chunk<S::CP>(Wos, wo, I, C, j0);
    __syncthreads();
    mm<RM, NJ, kChunk>(acc, Gs, kLDO, 1, Wos, 1, kLDO);  // gated Wo[:, chunk]^T
    __syncthreads();  // Gs and Wos are read before the next chunk writes them
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + RM * t_y + i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = t_x + 16 * j;
      if (c < C) {
        const long long idx = (long long)row * C + c;
        out[idx] = x[idx] + acc[i][j] + bo[c];
      }
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
    ff_f32_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ wp, const float* __restrict__ bp,
                      const float* __restrict__ wo, float* __restrict__ dx, int T, int C, int I,
                      float eps) {
  using S = FfF32Shape<NS, 16>;
  constexpr int NJ = S::NJ, LDX = S::LDX, CP = S::CP;
  constexpr int kLDD = 2 * kChunk + 1;
  extern __shared__ float sm[];
  float* Xn = sm;                      // 16 x LDX
  float* Gd = Xn + 16 * LDX;           // 16 x LDX, the cotangent
  float* Ws = Gd + 16 * LDX;           // 64 x kLDW
  float* Wos = Ws + 2 * kChunk * kLDW; // CP x kLDO
  float* Dh = Wos + CP * kLDO;         // 16 x kLDD, the chunk's dh2
  float* mu_s = Dh + 16 * kLDD;
  float* rstd_s = mu_s + 16;
  const int row0 = blockIdx.x * 16, t_y = ty(), t_x = tx();
  layer_norm_rows<16, CP, LDX>(Xn, x, gamma, beta, row0, T, C, eps, mu_s, rstd_s);
  load_tile<16, CP, LDX>(Gd, g, C, row0, T, 0, C);
  float acc[1][NJ];
  zero(acc);
  for (int j0 = 0; j0 < I; j0 += kChunk) {
    float h2[1][4];
    chunk_projection<1, NS, LDX>(h2, Xn, Ws, wp, I, C, j0);
    load_wo_chunk<CP>(Wos, wo, I, C, j0);
    __syncthreads();
    float dg[1][2];
    zero(dg);
    mm<1, 2, CP>(dg, Gd, LDX, 1, Wos, kLDO, 1);  // dgated = dout Wo[:, chunk]
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = t_x + 16 * j;
      const float h = h2[0][j] + bp[j0 + col];
      float gelu, dgelu;
      gelu_erf_grad(h2[0][j + 2] + bp[I + j0 + col], gelu, dgelu);
      Dh[t_y * kLDD + col] = dg[0][j] * gelu;
      Dh[t_y * kLDD + kChunk + col] = dg[0][j] * h * dgelu;
    }
    // acc += dh2 (16 x 64) Wp[chunk rows, :], the Wp slabs read again
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      __syncthreads();  // Dh is written; the slab's previous readers are done
      load_wp_slab(Ws, wp, I, C, j0, s * kSlab);
      __syncthreads();
      float part[1][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) part[0][j] = acc[0][4 * s + j];
      mm<1, 4, 2 * kChunk>(part, Dh, kLDD, 1, Ws, kLDW, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][4 * s + j] = part[0][j];
    }
  }
  // dxn = acc gamma; per row the sums of dxn and dxn xhat over the C columns
  const int row = row0 + t_y;
  const float mu = mu_s[t_y], rstd = rstd_s[t_y];
  float xh[NJ];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = t_x + 16 * j;
    const bool in = c < C && row < T;
    xh[j] = in ? (x[(long long)row * C + c] - mu) * rstd : 0.0f;
    acc[0][j] = c < C ? acc[0][j] * gamma[c] : 0.0f;
    s1 += acc[0][j];
    s2 += acc[0][j] * xh[j];
  }
  const float m1 = group_sum(s1) / C, m2 = group_sum(s2) / C;
  if (row >= T) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = t_x + 16 * j;
    if (c < C)
      dx[(long long)row * C + c] = Gd[t_y * LDX + c] + rstd * (acc[0][j] - m1 - xh[j] * m2);
  }
}

template <int NS>
size_t ff_smem() {
  using S = FfF32Shape<NS, 32>;
  return ((size_t)32 * S::LDX + 2 * kChunk * kLDW + 32 * kLDO + (size_t)S::CP * kLDO) *
         sizeof(float);
}

template <int NS>
size_t ff_bwd_smem() {
  using S = FfF32Shape<NS, 16>;
  return ((size_t)2 * 16 * S::LDX + 2 * kChunk * kLDW + (size_t)S::CP * kLDO +
          16 * (2 * kChunk + 1) + 32) * sizeof(float);
}

struct FfArgs {
  const float *x, *g, *gamma, *beta, *wp, *bp, *wo, *bo;
  float* out;
  int T, C, I;
  float eps;
};

template <int NS>
int launch(const FfArgs& a, bool backward, cudaStream_t stream) {
  if (backward) {
    const dim3 grid((a.T + 15) / 16);
    E2V_LAUNCH(ff_f32_bwd_kernel<NS>, grid, kThreads, ff_bwd_smem<NS>(), stream, a.x, a.g,
               a.gamma, a.beta, a.wp, a.bp, a.wo, a.out, a.T, a.C, a.I, a.eps);
  }
  const dim3 grid((a.T + 31) / 32);
  E2V_LAUNCH(ff_f32_kernel<NS>, grid, kThreads, ff_smem<NS>(), stream, a.x, a.gamma, a.beta,
             a.wp, a.bp, a.wo, a.bo, a.out, a.T, a.C, a.I, a.eps);
}

int dispatch(const FfArgs& a, bool backward, void* stream) {
  if (a.C % 8 != 0 || a.C < 8 || a.C > 640 || a.I % kChunk != 0 || a.I == 0)
    return (int)cudaErrorInvalidValue;
  if (a.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((a.C + 63) / 64) {
    case 1: return launch<1>(a, backward, s);
    case 2: return launch<2>(a, backward, s);
    case 3: return launch<3>(a, backward, s);
    case 4: return launch<4>(a, backward, s);
    case 5: return launch<5>(a, backward, s);
    case 6: return launch<6>(a, backward, s);
    case 7: return launch<7>(a, backward, s);
    case 8: return launch<8>(a, backward, s);
    case 9: return launch<9>(a, backward, s);
    case 10: return launch<10>(a, backward, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace f32k
}  // namespace e2v

// x, out (T, C); gamma, beta, bo (C); wp (2I, C) (nn.Linear layout), bp (2I);
// wo (C, I); all f32, contiguous. C % 8 == 0, C <= 640, I % 32 == 0.
// Returns the CUDA launch status.
extern "C" int e2v_ff_f32(const void* x, const void* gamma, const void* beta, const void* wp,
                          const void* bp, const void* wo, const void* bo, void* out, int T,
                          int C, int I, float eps, void* stream) {
  e2v::f32k::FfArgs a = {static_cast<const float*>(x), nullptr,
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const float*>(wp), static_cast<const float*>(bp),
                         static_cast<const float*>(wo), static_cast<const float*>(bo),
                         static_cast<float*>(out), T, C, I, eps};
  return e2v::f32k::dispatch(a, false, stream);
}

// dx of e2v_ff_f32 from x and the output's gradient g (T, C), f32; the same
// shapes and rules (bo is not needed). Returns the CUDA launch status.
extern "C" int e2v_ff_f32_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                              const void* wp, const void* bp, const void* wo, void* dx, int T,
                              int C, int I, float eps, void* stream) {
  e2v::f32k::FfArgs a = {static_cast<const float*>(x), static_cast<const float*>(g),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const float*>(wp), static_cast<const float*>(bp),
                         static_cast<const float*>(wo), nullptr,
                         static_cast<float*>(dx), T, C, I, eps};
  return e2v::f32k::dispatch(a, true, stream);
}

// ff_f32 / ff_f32_bwd: the f32 counterparts of ff_ln / ff_ln_bwd, the whole
// pre-LN GEGLU feed-forward block with its residual and its input gradient,
//   out = x + (h * gelu_erf(g)) Wo^T + bo,   [h | g] = LN(x) Wp^T + bp
//   (or, for a tensor-parallel rank's partial product, without the x),
//   dx  = dout + rstd (dxn - mean(dxn) - xhat mean(dxn xhat)),
//         dxn = (dh2 Wp) gamma, dh2 = [dgated gelu(g) | dgated h gelu'(g)],
//         dgated = dout Wo.
//
// Replaces (JAX package, eeg2video_tpu/ops/geglu.py), where it runs on f32
// operands (fused_ff_ln tests no dtype, :407): _ff_pallas :242 (_ff_kernel
// :213) and _ff_bwd_pallas :324 (_ff_bwd_kernel :280).
//
// Any C % 8 == 0 up to 640, I % 64 == 0, any T. Every operand row starts
// 16-byte aligned (the wrapper sees to it). erff / expf in f32.
//
// What bounds it on the H100: 6 T C I operations forward and 10 T C I
// backward. An f32 product has to keep f32 accuracy, so the least time is
// three tf32 products at the tensor cores' dense TF32 rate (494.7 TFLOP/s);
// the bytes (x, dout, out and the (T, I) / (T, 2I) intermediate below) stay
// under a tenth of that time at the model's shapes.
//
// Design: GEMM-shaped kernels on 3xTF32 (tf32_mma.cuh), with the gated (T, I)
// (forward) or dh2 (T, 2I) (backward) intermediate in a workspace the wrapper
// allocates. One row block that owns all of C cannot be kept tall in f32: at
// C = 640, 64 rows of LN(x) split into big and small tiles take 328 KB of
// shared memory, and at 16-32 rows every block streams all the weights.
//   forward:  ff_f32_ln_stats (mu, rstd a row) -> ff_f32_gate: [h | g] over a
//             64-column chunk of I (h and g of the same columns, so the gate
//             is applied in registers) -> gated; ff_f32_out: gated Wo^T + bo +
//             x;
//   backward: ff_f32_bwd_ln_stats -> ff_f32_bwd_dh2: [h | g] of the chunk,
//             then dgated = dout Wo over the same chunk, the gate's backward in
//             registers -> dh2; ff_f32_bwd_dxa: dh2 Wp into dx; ff_f32_bwd_ln:
//             a row pass (one warp a row) that finishes the LayerNorm
//             backward in place.
// The GEMMs (tf32_gemm.cuh, shared with geglu_f32.cu): 128-row block tiles,
// 8 warps (2 along the rows x 4 along the columns) of 64 x 32 (or 64 x 40)
// warp tiles, k in 32-wide slabs through a three-stage cp.async ring. Each
// landed slab of both operands is split once, in shared memory, into big and
// small tiles that every warp reads (LayerNorm applied to an x slab in the
// same pass); each slab's products run into fresh accumulators, added to the
// totals by f32 adds. The forward's gate reads the
// rows of Wp of one chunk's h and g columns as one 128-row B tile.
//
// Every sum runs in one fixed order (slabs and k in order, row reductions by
// xor-shuffles): no atomics, the same bits on every run, and a row's bits do
// not depend on the other rows of the call.
#include "tf32_gemm.cuh"

namespace e2v {
namespace f32k {
namespace {

constexpr int kChunk = 64;      // columns of I per gate / dh2 block (128 rows of Wp)

// split_tile (tf32_gemm.cuh) for a landed x slab (columns k0 ..), LayerNorm
// first: (x - mu) rstd gamma + beta below C, zero from C on
__device__ __forceinline__ void split_ln_tile(float* big, float* small, const float* raw,
                                              const float* mu_s, const float* rstd_s,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, int k0, int C) {
  constexpr int C4 = kBK / 4;
  for (int i = threadIdx.x; i < kBM * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4, off = r * kLDK + c, k = k0 + c;
    float4 v = *reinterpret_cast<const float4*>(raw + off);
    if (k < C) {  // C % 8 == 0: the 4 columns are all below C or all past it
      const float mu = mu_s[r], rs = rstd_s[r];
      v.x = (v.x - mu) * rs * gamma[k] + beta[k];
      v.y = (v.y - mu) * rs * gamma[k + 1] + beta[k + 1];
      v.z = (v.z - mu) * rs * gamma[k + 2] + beta[k + 2];
      v.w = (v.w - mu) * rs * gamma[k + 3] + beta[k + 3];
    } else {
      v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float4 b, s;
    split4(v, b, s);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = s;
  }
}

// --- LayerNorm statistics, the gate, the out GEMM ----------------------------

// mu and rstd of each row, one warp a row, sums in lane order then by
// xor-shuffles
__device__ __forceinline__ void ln_stats(const float* __restrict__ x, float* mu, float* rstd,
                                         int T, int C, float eps) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= T) return;
  const float* xr = x + (long long)row * C;
  float sum = 0.0f;
  for (int c = lane; c < C; c += 32) sum += xr[c];
  const float m = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c] - m;
    sq += v * v;
  }
  const float r = rsqrtf(warp_sum(sq) / C + eps);
  if (lane == 0) mu[row] = m, rstd[row] = r;
}

__global__ void __launch_bounds__(kThreads)
    ff_f32_ln_stats_kernel(const float* __restrict__ x, float* mu, float* rstd, int T, int C,
                           float eps) {
  ln_stats(x, mu, rstd, T, C, eps);
}

__global__ void __launch_bounds__(kThreads)
    ff_f32_bwd_ln_stats_kernel(const float* __restrict__ x, float* mu, float* rstd, int T, int C,
                               float eps) {
  ln_stats(x, mu, rstd, T, C, eps);
}

using GateTiles = Tiles<kBM * kLDK>;  // B: the chunk's 64 h and 64 g rows of Wp

// The [h | g] projection of a 128-row tile over I columns j0 .. j0 + 63,
// slabs 0 .. nP - 1 of the block's ring: A the LN'd x slab, B the Wp rows of
// the chunk's h (tile rows 0-63) and g (64-127). A warp's n8 tiles 0, 1 are
// h columns wn 16 + 0..15, tiles 2, 3 the g columns of the same j.
struct GateOps {
  const GateTiles& sh;
  const float *x, *wp, *gamma, *beta, *mu_s, *rstd_s;
  int r0, j0, T, C, I;
  __device__ void land(int s) const {
    const int r0_ = r0, j0_ = j0, I_ = I;
    land_k<kBM>(sh.a_raw(s), x, C, T, s * kBK, C, [=](int r) { return r0_ + r; });
    land_k<kBM>(sh.b_raw(s), wp, C, 2 * I, s * kBK, C,
                [=](int r) { return r < kChunk ? j0_ + r : I_ + j0_ + r - kChunk; });
  }
  __device__ void split(int s) const {
    split_ln_tile(sh.ab(), sh.as(), sh.a_raw(s), mu_s, rstd_s, gamma, beta, s * kBK, C);
    split_tile(sh.bb(), sh.bs(), sh.b_raw(s), kBM, kBK / 4, kLDK);
  }
  __device__ void mma(float (&acc)[4][4][4], int wm, int wn, int lane) const {
    slab_mma<4, kRowsN, kLDK>(acc, sh.ab() + wm * 64 * kLDK, sh.as() + wm * 64 * kLDK, sh.bb(),
                              sh.bs(),
                              [=](int j) { return (j >> 1) * kChunk + wn * 16 + (j & 1) * 8; },
                              lane);
  }
};

__device__ __forceinline__ void load_stats(float* mu_s, float* rstd_s, const float* mu,
                                           const float* rstd, int r0, int T) {
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const bool in = r0 + r < T;
    mu_s[r] = in ? mu[r0 + r] : 0.0f;
    rstd_s[r] = in ? rstd[r0 + r] : 0.0f;
  }
}

// gated[r0 .., j0 .. j0 + 63] = h gelu(g), [h | g] = LN(x) Wp^T + bp
__global__ void __launch_bounds__(kThreads, 1)
    ff_f32_gate_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                       const float* __restrict__ rstd, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ wp,
                       const float* __restrict__ bp, float* __restrict__ gated, int T, int C,
                       int I) {
  extern __shared__ float4 smem4[];
  const GateTiles sh(reinterpret_cast<float*>(smem4));
  float* mu_s = sh.sm + GateTiles::kFloats;
  float* rstd_s = mu_s + kBM;
  const int nj = I / kChunk, r0 = (blockIdx.x / nj) * kBM, j0 = (blockIdx.x % nj) * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  load_stats(mu_s, rstd_s, mu, rstd, r0, T);
  const GateOps op{sh, x, wp, gamma, beta, mu_s, rstd_s, r0, j0, T, C, I};
  const int n = (C + kBK - 1) / kBK;
  float acc[4][4][4];
  zero_acc(acc);
  auto land = [&](int s) { op.land(s); };
  prologue(n, land);
  slabs(0, n, n, land, [&](int s) { op.split(s); }, [&](int) { op.mma(acc, wm, wn, lane); });
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= T) continue;
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int j = j0 + wn * 16 + jt * 8 + 2 * tq;
        float2 o;
        o.x = (acc[i][jt][2 * h] + bp[j]) * gelu_erf(acc[i][jt + 2][2 * h] + bp[I + j]);
        o.y = (acc[i][jt][2 * h + 1] + bp[j + 1]) *
              gelu_erf(acc[i][jt + 2][2 * h + 1] + bp[I + j + 1]);
        *reinterpret_cast<float2*>(gated + (long long)row * I + j) = o;
      }
    }
}

// out = x + gated Wo^T + bo over a 128-row x kOutN-column tile (x null: no x)
__global__ void __launch_bounds__(kThreads, 1)
    ff_f32_out_kernel(const float* __restrict__ x, const float* __restrict__ gated,
                      const float* __restrict__ wo, const float* __restrict__ bo,
                      float* __restrict__ out, int T, int C, int I) {
  extern __shared__ float4 smem4[];
  const int nc = (C + kOutN - 1) / kOutN;
  const int r0 = (blockIdx.x / nc) * kBM, n0 = (blockIdx.x % nc) * kOutN;
  float acc[4][5][4];
  out_gemm<kRowsN>(acc, reinterpret_cast<float*>(smem4), gated, wo, T, I, C, r0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = out_row(r0, i, h);
      if (row >= T) continue;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int c = out_col(n0, j);
        if (c >= C) continue;
        const long long idx = (long long)row * C + c;
        const float2 xv = x ? *reinterpret_cast<const float2*>(x + idx) : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(out + idx) =
            make_float2(xv.x + acc[i][j][2 * h] + bo[c], xv.y + acc[i][j][2 * h + 1] + bo[c + 1]);
      }
    }
}

// --- the backward ------------------------------------------------------------

// dh2[r0 .., (j0 .. j0 + 63) and (I + j0 ..)] of a 128-row tile: the [h | g]
// projection (slabs 0 .. nP - 1), the gate's values and derivative in
// registers, then dgated = dout Wo[:, j0 .. j0 + 63] (slabs nP .., B rows k:
// rows c of Wo); the warp's dgated n8 tiles 0, 1 are the columns of its h
// tiles 0, 1, so one lane holds h, g and dgated of the same elements
__global__ void __launch_bounds__(kThreads, 1)
    ff_f32_bwd_dh2_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                          const float* __restrict__ mu, const float* __restrict__ rstd,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ wp, const float* __restrict__ bp,
                          const float* __restrict__ wo, float* __restrict__ dh2, int T, int C,
                          int I) {
  constexpr int kLDD = kChunk + 8;  // row stride of the Wo slab (32 rows c x 64 columns j)
  extern __shared__ float4 smem4[];
  const GateTiles sh(reinterpret_cast<float*>(smem4));
  float* mu_s = sh.sm + GateTiles::kFloats;
  float* rstd_s = mu_s + kBM;
  const int nj = I / kChunk, r0 = (blockIdx.x / nj) * kBM, j0 = (blockIdx.x % nj) * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  load_stats(mu_s, rstd_s, mu, rstd, r0, T);
  const GateOps op{sh, x, wp, gamma, beta, mu_s, rstd_s, r0, j0, T, C, I};
  const int np = (C + kBK - 1) / kBK, n = 2 * np;
  auto land = [&](int s) {
    if (s < np) {
      op.land(s);
    } else {
      const int k0 = (s - np) * kBK;
      land_k<kBM>(sh.a_raw(s), dout, C, T, k0, C, [=](int r) { return r0 + r; });
      land_n<kChunk>(sh.b_raw(s), wo, I, k0, C, j0, I);
    }
  };
  prologue(n, land);
  float acc[4][4][4];
  zero_acc(acc);
  slabs(0, np, n, land, [&](int s) { op.split(s); }, [&](int) { op.mma(acc, wm, wn, lane); });
  // h2 -> (gelu(g), h gelu'(g)) in place
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + wn * 16 + jt * 8 + 2 * tq + (e & 1);
        const float h = acc[i][jt][e] + bp[j];
        float gelu, dgelu;
        gelu_erf_grad(acc[i][jt + 2][e] + bp[I + j], gelu, dgelu);
        acc[i][jt][e] = gelu;
        acc[i][jt + 2][e] = h * dgelu;
      }
  float dg[4][2][4];
  zero_acc(dg);
  slabs(np, n, n, land,
        [&](int s) {
          split_tile(sh.ab(), sh.as(), sh.a_raw(s), kBM, kBK / 4, kLDK);
          split_tile(sh.bb(), sh.bs(), sh.b_raw(s), kBK, kChunk / 4, kLDD);
        },
        [&](int) {
          slab_mma<2, kRowsK, kLDD>(dg, sh.ab() + wm * 64 * kLDK, sh.as() + wm * 64 * kLDK,
                                    sh.bb(), sh.bs(), [=](int j) { return wn * 16 + j * 8; },
                                    lane);
        });
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= T) continue;
      float* dr = dh2 + (long long)row * 2 * I;
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int j = j0 + wn * 16 + jt * 8 + 2 * tq;
        const float d0 = dg[i][jt][2 * h], d1 = dg[i][jt][2 * h + 1];
        *reinterpret_cast<float2*>(dr + j) =
            make_float2(d0 * acc[i][jt][2 * h], d1 * acc[i][jt][2 * h + 1]);
        *reinterpret_cast<float2*>(dr + I + j) =
            make_float2(d0 * acc[i][jt + 2][2 * h], d1 * acc[i][jt + 2][2 * h + 1]);
      }
    }
}

// dxa = dh2 Wp over a 128-row x kOutN-column tile (B rows k: the rows of Wp),
// into dx
__global__ void __launch_bounds__(kThreads, 1)
    ff_f32_bwd_dxa_kernel(const float* __restrict__ dh2, const float* __restrict__ wp,
                          float* __restrict__ dxa, int T, int C, int I) {
  extern __shared__ float4 smem4[];
  const int nc = (C + kOutN - 1) / kOutN;
  const int r0 = (blockIdx.x / nc) * kBM, n0 = (blockIdx.x % nc) * kOutN;
  float acc[4][5][4];
  out_gemm<kRowsK>(acc, reinterpret_cast<float*>(smem4), dh2, wp, T, 2 * I, C, r0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = out_row(r0, i, h);
      if (row >= T) continue;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int c = out_col(n0, j);
        if (c < C)
          *reinterpret_cast<float2*>(dxa + (long long)row * C + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// dx = dout + rstd (dxn - m1 - xhat m2), dxn = dxa gamma, m1 = mean(dxn),
// m2 = mean(dxn xhat): one warp a row, dxa read from dx and overwritten
__global__ void __launch_bounds__(kThreads)
    ff_f32_bwd_ln_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                         const float* __restrict__ mu, const float* __restrict__ rstd,
                         const float* __restrict__ gamma, float* dx, int T, int C) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= T) return;
  const long long base = (long long)row * C;
  const float m = mu[row], rs = rstd[row];
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float dxn = dx[base + c] * gamma[c], xh = (x[base + c] - m) * rs;
    s1 += dxn;
    s2 += dxn * xh;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int c = lane; c < C; c += 32) {
    const float dxn = dx[base + c] * gamma[c], xh = (x[base + c] - m) * rs;
    dx[base + c] = dout[base + c] + rs * (dxn - m1 - xh * m2);
  }
}

// --- host --------------------------------------------------------------------

constexpr size_t kGateSmem = (GateTiles::kFloats + 2 * kBM) * sizeof(float);
static_assert(kGateSmem <= 232448, "a block's shared memory");

struct FfArgs {
  const float *x, *g, *gamma, *beta, *wp, *bp, *wo, *bo;
  float *out, *work;
  int T, C, I;
  float eps;
  const float* xres;  // the residual added to the forward's output, or null
};

int run(const FfArgs& a, bool backward, cudaStream_t s) {
  const long long T = a.T, rows = (T + kBM - 1) / kBM, warp_rows = (T + 7) / 8;
  const long long cols = (a.C + kOutN - 1) / kOutN, chunks = a.I / kChunk;
  // the workspace: the intermediate (T x I forward, T x 2I backward), mu, rstd
  float* inter = a.work;
  float* mu = inter + T * (backward ? 2 : 1) * a.I;
  float* rstd = mu + T;
  int rc;
  if (!backward) {
    if ((rc = launch(ff_f32_ln_stats_kernel, warp_rows, 0, s, a.x, mu, rstd, a.T, a.C, a.eps)))
      return rc;
    if ((rc = launch(ff_f32_gate_kernel, rows * chunks, kGateSmem, s, a.x, (const float*)mu,
                     (const float*)rstd, a.gamma, a.beta, a.wp, a.bp, inter, a.T, a.C, a.I)))
      return rc;
    return launch(ff_f32_out_kernel, rows * cols, kOutSmem, s, a.xres, (const float*)inter, a.wo,
                  a.bo, a.out, a.T, a.C, a.I);
  }
  if ((rc = launch(ff_f32_bwd_ln_stats_kernel, warp_rows, 0, s, a.x, mu, rstd, a.T, a.C, a.eps)))
    return rc;
  if ((rc = launch(ff_f32_bwd_dh2_kernel, rows * chunks, kGateSmem, s, a.x, a.g,
                   (const float*)mu, (const float*)rstd, a.gamma, a.beta, a.wp, a.bp, a.wo, inter,
                   a.T, a.C, a.I)))
    return rc;
  if ((rc = launch(ff_f32_bwd_dxa_kernel, rows * cols, kOutKSmem, s, (const float*)inter, a.wp,
                   a.out, a.T, a.C, a.I)))
    return rc;
  return launch(ff_f32_bwd_ln_kernel, warp_rows, 0, s, a.x, a.g, (const float*)mu,
                (const float*)rstd, a.gamma, a.out, a.T, a.C);
}

int dispatch(const FfArgs& a, bool backward, void* stream) {
  if (a.C % 8 != 0 || a.C < 8 || a.C > 640 || a.I % kChunk != 0 || a.I <= 0 || a.T < 0)
    return (int)cudaErrorInvalidValue;
  if (a.T == 0) return 0;  // the workspace of no rows is empty: its pointer may be null
  if (a.work == nullptr) return (int)cudaErrorInvalidValue;
  return run(a, backward, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace f32k
}  // namespace e2v

// x, out (T, C); gamma, beta, bo (C); wp (2I, C) (nn.Linear layout), bp (2I);
// wo (C, I); work, the workspace (T I + 2 T floats); all f32, contiguous,
// 16-byte aligned. C % 8 == 0, C <= 640, I % 64 == 0. residual 0 leaves x
// out of the sum (x then feeds LayerNorm only). Returns the CUDA launch status.
extern "C" int e2v_ff_f32(const void* x, const void* gamma, const void* beta, const void* wp,
                          const void* bp, const void* wo, const void* bo, void* out, void* work,
                          int T, int C, int I, float eps, void* stream, int residual) {
  e2v::f32k::FfArgs a = {static_cast<const float*>(x), nullptr,
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const float*>(wp), static_cast<const float*>(bp),
                         static_cast<const float*>(wo), static_cast<const float*>(bo),
                         static_cast<float*>(out), static_cast<float*>(work), T, C, I, eps,
                         residual ? static_cast<const float*>(x) : nullptr};
  return e2v::f32k::dispatch(a, false, stream);
}

// dx of e2v_ff_f32 from x and the output's gradient g (T, C), f32; the same
// shapes and rules (bo is not needed; work holds T 2I + 2 T floats). Returns
// the CUDA launch status.
extern "C" int e2v_ff_f32_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                              const void* wp, const void* bp, const void* wo, void* dx,
                              void* work, int T, int C, int I, float eps, void* stream) {
  e2v::f32k::FfArgs a = {static_cast<const float*>(x), static_cast<const float*>(g),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const float*>(wp), static_cast<const float*>(bp),
                         static_cast<const float*>(wo), nullptr,
                         static_cast<float*>(dx), static_cast<float*>(work), T, C, I, eps,
                         nullptr};
  return e2v::f32k::dispatch(a, true, stream);
}

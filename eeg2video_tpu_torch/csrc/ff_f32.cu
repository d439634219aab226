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
// The GEMMs: 128-row block tiles, 8 warps (2 along the rows x 4 along the
// columns) of 64 x 32 (or 64 x 40) warp tiles, k in 32-wide slabs through a
// three-stage cp.async ring. Each landed slab of both operands is split once,
// in shared memory, into big and small tiles that every warp reads (LayerNorm
// applied to an x slab in the same pass); each slab's products run into fresh
// accumulators, added to the totals by f32 adds. The forward's gate reads the
// rows of Wp of one chunk's h and g columns as one 128-row B tile.
//
// Every sum runs in one fixed order (slabs and k in order, row reductions by
// xor-shuffles): no atomics, the same bits on every run, and a row's bits do
// not depend on the other rows of the call.
#include "tf32_mma.cuh"

namespace e2v {
namespace f32k {
namespace {

constexpr int kThreads = 256;   // 8 warps: 2 along the rows x 4 along the columns
constexpr int kBM = 128;        // rows of a block tile
constexpr int kBK = 32;         // k of a slab: one run of fresh accumulators
constexpr int kLDK = kBK + 4;   // row stride of a tile with k along its rows (A; B as rows n)
constexpr int kStages = 3;      // the landing ring
constexpr int kChunk = 64;      // columns of I per gate / dh2 block (128 rows of Wp)
constexpr int kOutN = 160;      // columns of C per out / dxa block
constexpr int kRowsN = 0, kRowsK = 1;  // B tile layouts: its rows are n (k along them), or k

// Shared memory: the ring of landed A and B slabs, then the split tiles
// (A big, A small, B big, B small); BE floats a B tile
template <int BE>
struct Tiles {
  static constexpr int kA = kBM * kLDK;
  static constexpr int kStage = kA + BE;
  static constexpr int kFloats = kStages * kStage + 2 * kA + 2 * BE;
  float* sm;
  __device__ explicit Tiles(float* s) : sm(s) {}
  __device__ float* a_raw(int s) const { return sm + (s % kStages) * kStage; }
  __device__ float* b_raw(int s) const { return a_raw(s) + kA; }
  __device__ float* ab() const { return sm + kStages * kStage; }
  __device__ float* as() const { return ab() + kA; }
  __device__ float* bb() const { return as() + kA; }
  __device__ float* bs() const { return bb() + BE; }
};

// ROWS rows x columns k0 .. k0 + 31 of a row-major matrix (row stride ld)
// into a tile of row stride kLDK by cp.async; tile row r is matrix row
// row_of(r); rows from nrows on and columns from K on are zero-filled
template <int ROWS, class RowOf>
__device__ __forceinline__ void land_k(float* dst, const float* src, long long ld, int nrows,
                                       int k0, int K, RowOf row_of) {
  constexpr int C4 = kBK / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4, row = row_of(r);
    const bool valid = row < nrows && k0 + c < K;
    cp_async16(dst + r * kLDK + c, valid ? src + (long long)row * ld + k0 + c : src, valid);
  }
}

// rows k0 .. k0 + 31 x columns n0 .. n0 + BN - 1 of a row-major matrix
// (row stride ld) into a tile of row stride BN + 8; rows from K on and
// columns from N on are zero-filled
template <int BN>
__device__ __forceinline__ void land_n(float* dst, const float* src, long long ld, int k0, int K,
                                       int n0, int N) {
  constexpr int C4 = BN / 4;
  for (int i = threadIdx.x; i < kBK * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool valid = k0 + r < K && n0 + c < N;
    cp_async16(dst + r * (BN + 8) + c, valid ? src + (long long)(k0 + r) * ld + n0 + c : src,
               valid);
  }
}

// The big and small tiles of a landed tile: rows x C4 float4s, row stride ld
__device__ __forceinline__ void split_tile(float* big, float* small, const float* raw, int rows,
                                           int C4, int ld) {
  for (int i = threadIdx.x; i < rows * C4; i += kThreads) {
    const int off = (i / C4) * ld + (i % C4) * 4;
    float4 b, s;
    split4(*reinterpret_cast<const float4*>(raw + off), b, s);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = s;
  }
}

// The same for a landed x slab (columns k0 ..), LayerNorm first: (x - mu)
// rstd gamma + beta below C, zero from C on
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

// acc += the warp's 64 rows (ab / as at its first row) x its WN n8 tiles of B
// over one slab, 3xTF32, summed in fresh accumulators first. n8 tile j
// starts at B row (kRowsN) or column (kRowsK) nb(j); with kRowsN the tiles
// come in pairs nb(j + 1) == nb(j) + 8 (j even) by ldmatrix, an odd last one
// by scalar loads
template <int WN, int L, int LDB, class NB>
__device__ __forceinline__ void slab_mma(float (&acc)[4][WN][4], const float* ab, const float* as,
                                         const float* bb, const float* bs, NB nb, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  float t[4][WN][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) zero(t[i]);
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    uint32_t b[WN][2], s[WN][2];
    if constexpr (L == kRowsN) {
#pragma unroll
      for (int j = 0; j + 1 < WN; j += 2) {
        uint32_t rb[4], rs[4];
        load_b_rows32<LDB>(rb, bb, nb(j), kk * 8, lane);
        load_b_rows32<LDB>(rs, bs, nb(j), kk * 8, lane);
        b[j][0] = rb[0], b[j][1] = rb[1], b[j + 1][0] = rb[2], b[j + 1][1] = rb[3];
        s[j][0] = rs[0], s[j][1] = rs[1], s[j + 1][0] = rs[2], s[j + 1][1] = rs[3];
      }
      if constexpr (WN % 2 == 1) {
        const int o = (nb(WN - 1) + g) * LDB + kk * 8 + tq;
        b[WN - 1][0] = __float_as_uint(bb[o]), b[WN - 1][1] = __float_as_uint(bb[o + 4]);
        s[WN - 1][0] = __float_as_uint(bs[o]), s[WN - 1][1] = __float_as_uint(bs[o + 4]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int o = (kk * 8 + tq) * LDB + nb(j) + g;
        b[j][0] = __float_as_uint(bb[o]), b[j][1] = __float_as_uint(bb[o + 4 * LDB]);
        s[j][0] = __float_as_uint(bs[o]), s[j][1] = __float_as_uint(bs[o + 4 * LDB]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a_b[4], a_s[4];
      load_a32<kLDK>(a_b, a_s, ab + i * 16 * kLDK, as + i * 16 * kLDK, kk * 8, lane);
#pragma unroll
      for (int j = 0; j < WN; ++j) mma3(t[i][j], a_b, a_s, b[j][0], b[j][1], s[j][0], s[j][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j) add_tile(acc[i][j], t[i][j]);
}

// The slab loop over slabs s0 .. s1 - 1 of n (the ring's first kStages - 1
// slabs issued by prologue): wait for slab s, split it (one barrier before:
// the split tiles' readers are done; one after), issue slab s + kStages - 1
// into the ring slot slab s - 1 left, run slab s's products meanwhile
template <class Land>
__device__ __forceinline__ void prologue(int n, Land land) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) land(s);
    cp_async_commit();
  }
}

template <class Land, class Split, class Mma>
__device__ __forceinline__ void slabs(int s0, int s1, int n, Land land, Split split, Mma mma) {
  for (int s = s0; s < s1; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < n) land(s + kStages - 1);
    cp_async_commit();
    split(s);
    __syncthreads();
    mma(s);
  }
}

template <int WN>
__device__ __forceinline__ void zero_acc(float (&acc)[4][WN][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) zero(acc[i]);
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

// A 128-row x kOutN-column tile of A B^T (k along both, B rows n: kRowsN) or
// A B (B rows k: kRowsK), A (M, K) and B row-major, K % 32 need not hold:
// the warp's 64 x 40 accumulators; the caller stores them
template <int L>
struct OutTiles {
  static constexpr int kBE = L == kRowsN ? kOutN * kLDK : kBK * (kOutN + 8);
  static constexpr int kLDB = L == kRowsN ? kLDK : kOutN + 8;
  using Smem = Tiles<kBE>;
};

template <int L>
__device__ __forceinline__ void out_gemm(float (&acc)[4][5][4], float* smem,
                                         const float* __restrict__ a, const float* __restrict__ b,
                                         int M, int K, int N, int r0, int n0) {
  using O = OutTiles<L>;
  const typename O::Smem sh(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const int n = (K + kBK - 1) / kBK;
  auto land = [&](int s) {
    land_k<kBM>(sh.a_raw(s), a, K, M, s * kBK, K, [=](int r) { return r0 + r; });
    if constexpr (L == kRowsN)
      land_k<kOutN>(sh.b_raw(s), b, K, N, s * kBK, K, [=](int r) { return n0 + r; });
    else
      land_n<kOutN>(sh.b_raw(s), b, N, s * kBK, K, n0, N);
  };
  auto split = [&](int s) {
    split_tile(sh.ab(), sh.as(), sh.a_raw(s), kBM, kBK / 4, kLDK);
    if constexpr (L == kRowsN)
      split_tile(sh.bb(), sh.bs(), sh.b_raw(s), kOutN, kBK / 4, kLDK);
    else
      split_tile(sh.bb(), sh.bs(), sh.b_raw(s), kBK, kOutN / 4, kOutN + 8);
  };
  auto mma = [&](int) {
    slab_mma<5, L, O::kLDB>(acc, sh.ab() + wm * 64 * kLDK, sh.as() + wm * 64 * kLDK, sh.bb(),
                            sh.bs(), [=](int j) { return wn * 40 + j * 8; }, lane);
  };
  zero_acc(acc);
  prologue(n, land);
  slabs(0, n, n, land, split, mma);
}

// The (row, column) of element e of n8 tile (i, j) of this lane's warp tile
// in an out_gemm block: rows r0 + wm 64 + i 16 + g (+ 8 for e >= 2), columns
// n0 + wn 40 + j 8 + 2 tq (+ 1 for odd e)
__device__ __forceinline__ int out_row(int r0, int i, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return r0 + (warp >> 2) * 64 + i * 16 + (lane >> 2) + 8 * h;
}
__device__ __forceinline__ int out_col(int n0, int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return n0 + (warp & 3) * 40 + j * 8 + 2 * (lane & 3);
}

// out = x + gated Wo^T + bo over a 128-row x kOutN-column tile
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
        const float2 xv = *reinterpret_cast<const float2*>(x + idx);
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

template <class Kernel, class... Args>
int launch(Kernel kernel, long long blocks, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

constexpr size_t kGateSmem = (GateTiles::kFloats + 2 * kBM) * sizeof(float);
constexpr size_t kOutSmem = OutTiles<kRowsN>::Smem::kFloats * sizeof(float);
constexpr size_t kDxaSmem = OutTiles<kRowsK>::Smem::kFloats * sizeof(float);
static_assert(kGateSmem <= 232448 && kOutSmem <= 232448 && kDxaSmem <= 232448,
              "a block's shared memory");

struct FfArgs {
  const float *x, *g, *gamma, *beta, *wp, *bp, *wo, *bo;
  float *out, *work;
  int T, C, I;
  float eps;
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
    return launch(ff_f32_out_kernel, rows * cols, kOutSmem, s, a.x, (const float*)inter, a.wo,
                  a.bo, a.out, a.T, a.C, a.I);
  }
  if ((rc = launch(ff_f32_bwd_ln_stats_kernel, warp_rows, 0, s, a.x, mu, rstd, a.T, a.C, a.eps)))
    return rc;
  if ((rc = launch(ff_f32_bwd_dh2_kernel, rows * chunks, kGateSmem, s, a.x, a.g,
                   (const float*)mu, (const float*)rstd, a.gamma, a.beta, a.wp, a.bp, a.wo, inter,
                   a.T, a.C, a.I)))
    return rc;
  if ((rc = launch(ff_f32_bwd_dxa_kernel, rows * cols, kDxaSmem, s, (const float*)inter, a.wp,
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
// 16-byte aligned. C % 8 == 0, C <= 640, I % 64 == 0. Returns the
// CUDA launch status.
extern "C" int e2v_ff_f32(const void* x, const void* gamma, const void* beta, const void* wp,
                          const void* bp, const void* wo, const void* bo, void* out, void* work,
                          int T, int C, int I, float eps, void* stream) {
  e2v::f32k::FfArgs a = {static_cast<const float*>(x), nullptr,
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const float*>(wp), static_cast<const float*>(bp),
                         static_cast<const float*>(wo), static_cast<const float*>(bo),
                         static_cast<float*>(out), static_cast<float*>(work), T, C, I, eps};
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
                         static_cast<float*>(dx), static_cast<float*>(work), T, C, I, eps};
  return e2v::f32k::dispatch(a, true, stream);
}

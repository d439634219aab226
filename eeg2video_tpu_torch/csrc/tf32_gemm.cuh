// The GEMM machinery of the 3xTF32 kernels built from 128-row block tiles:
// the f32 feed-forward pair (ff_f32.cu) and the f32 GEGLU pair (geglu_f32.cu).
//
// A block of 8 warps (2 along the rows x 4 along the columns) owns a 128-row
// tile; a warp owns 64 rows x WN n8 tiles. k runs in 32-wide slabs through a
// three-stage cp.async ring. Each landed slab of both operands is split once,
// in shared memory, into big and small tf32 tiles that every warp reads
// (tf32_mma.cuh); each slab's products run into fresh accumulators, added to
// the totals by f32 adds (the tensor cores truncate as they accumulate). The
// slabs and the k steps inside them run in order: the same bits on every run,
// and a row's bits do not depend on the other rows of the call.
//
// out_gemm is the GEMM of a 128-row x kOutN-column tile, A (M, K) row-major
// times B^T (B rows n, k along them: kRowsN, nn.Linear weights) or B (B rows
// k: kRowsK), over all of K or a run of its slabs; the caller's epilogue
// stores the accumulators.
// Every operand row starts 16-byte aligned, K % 4 == 0 and N % 4 == 0.
#pragma once

#include "tf32_mma.cuh"

namespace e2v {
namespace f32k {

constexpr int kThreads = 256;   // 8 warps: 2 along the rows x 4 along the columns
constexpr int kBM = 128;        // rows of a block tile
constexpr int kBK = 32;         // k of a slab: one run of fresh accumulators
constexpr int kLDK = kBK + 4;   // row stride of a tile with k along its rows (A; B as rows n)
constexpr int kStages = 3;      // the landing ring
constexpr int kOutN = 160;      // columns of an out_gemm tile
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

// A 128-row x kOutN-column tile of A B^T (k along both, B rows n: kRowsN) or
// A B (B rows k: kRowsK), A (M, K) and B row-major, K % 32 need not hold,
// over the n slabs of k from slab s_first on (all of K by default): the
// warp's 64 x 40 accumulators; the caller stores them
template <int L>
struct OutTiles {
  static constexpr int kBE = L == kRowsN ? kOutN * kLDK : kBK * (kOutN + 8);
  static constexpr int kLDB = L == kRowsN ? kLDK : kOutN + 8;
  using Smem = Tiles<kBE>;
};

template <int L>
__device__ __forceinline__ void out_gemm(float (&acc)[4][5][4], float* smem,
                                         const float* __restrict__ a, const float* __restrict__ b,
                                         int M, int K, int N, int r0, int n0,
                                         int s_first = 0, int n = -1) {
  using O = OutTiles<L>;
  const typename O::Smem sh(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  if (n < 0) n = (K + kBK - 1) / kBK;
  auto land = [&](int s) {
    const int k0 = (s_first + s) * kBK;
    land_k<kBM>(sh.a_raw(s), a, K, M, k0, K, [=](int r) { return r0 + r; });
    if constexpr (L == kRowsN)
      land_k<kOutN>(sh.b_raw(s), b, K, N, k0, K, [=](int r) { return n0 + r; });
    else
      land_n<kOutN>(sh.b_raw(s), b, N, k0, K, n0, N);
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

constexpr size_t kOutSmem = OutTiles<kRowsN>::Smem::kFloats * sizeof(float);
constexpr size_t kOutKSmem = OutTiles<kRowsK>::Smem::kFloats * sizeof(float);
static_assert(kOutSmem <= 232448 && kOutKSmem <= 232448, "a block's shared memory");

// Launch kernel on blocks x kThreads threads with smem bytes of dynamic
// shared memory (its cap raised first where it passes 48 KiB); returns the
// CUDA launch status
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

}  // namespace f32k
}  // namespace e2v

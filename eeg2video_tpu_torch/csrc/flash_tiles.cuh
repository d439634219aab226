// Building blocks of the attention forward and backward kernels
// (flash_fwd.cuh, flash_bwd.cuh): bf16 tensor-core products with f32
// accumulators in registers (mma.sync.m16n8k16, operands from shared memory
// by ldmatrix), and tile copies from device to shared memory by cp.async,
// 16 bytes a thread, so that the next tile is in flight while the current
// one computes.
//
// Fragment layouts of m16n8k16 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16 bf16), 4 registers: a0 (row g, cols 2t, 2t+1), a1 (row g+8,
//     same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8 bf16, k x n), 2 registers: b0 (k 2t, 2t+1, col g), b1 (k 2t+8,
//     2t+9, col g);
//   C (16 x 8 f32), 4 registers: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g+8, same cols).
// So a row of a C tile sits on the 4 lanes of a quad (row sums: 2 shuffles),
// and the C fragments of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of the next product over those 16 columns: a
// probability tile goes from one product to the next without leaving the
// registers.
#pragma once

#include "common.cuh"

namespace e2v {

constexpr int kTileKV = 64;      // KV rows per tile (forward and dq pass)
constexpr int kTileQ = 64;       // query rows per tile (dkv pass)
constexpr int kMaxWarps = 8;     // a block is 4 or 8 warps of 16 rows each
constexpr int kMaxThreads = kMaxWarps * 32;

// Every head dim the attention kernels are instantiated for: D padded to the
// next multiple of 16 (D % 8 == 0, D <= 160 as the wrappers check)
#define E2V_ATTN_DPS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160)

// Rows of a shared-memory tile are DP + 8 bf16 values: an odd multiple of 16
// bytes, so the 8 row addresses of one ldmatrix fall on 8 different 16-byte
// bank groups (no conflicts) and every row start stays 16-byte aligned.
template <int DP>
__host__ __device__ constexpr int tile_ld() {
  return DP + 8;
}

// Warps per block (16 rows each) for a pass of `kernel` over `rows` rows in
// other_blocks grid cells; smem(w) is its dynamic shared memory at w warps.
// 8 warps (128 rows) where the grid of 128-row blocks still holds a block per
// SM and an SM keeps at least as many warps resident in 8-warp blocks as in
// 4-warp ones (the kernel's registers and shared memory decide: at D = 80 the
// 4-warp blocks of the forward and the dq pass fit three to an SM, the 8-warp
// ones one), else 4 (64 rows). Sets the kernel's dynamic shared-memory cap to
// its 8-warp size; returns 0 if the runtime refused a call.
template <class Kernel, class Smem>
int block_warps(Kernel kernel, Smem smem, int rows, int other_blocks) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem(8)) != cudaSuccess)
    return 0;
  if ((rows + 127) / 128 * other_blocks < 132) return 4;
  int n4 = 0, n8 = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n4, kernel, 4 * 32, smem(4)) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n8, kernel, 8 * 32, smem(8)) != cudaSuccess)
    return 0;
  return 8 * n8 >= 4 * n4 ? 8 : 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes device -> shared, zero-filled when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes device -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of bf16 pairs, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragment (16 rows x 16 columns from column k0) of a row-major tile
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int k0, int lane) {
  ldmatrix_x4(r, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (rows n0 .. n0+15 of a row-major tile, taken as
// the columns of B) over k = columns k0 .. k0+15: r[0], r[1] for rows n0..n0+7,
// r[2], r[3] for rows n0+8..n0+15. Used for the products against K^T, V^T,
// Q^T and dO^T.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const bf16* tile, int n0, int k0,
                                            int lane) {
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (columns n0 .. n0+15 of a row-major tile) over
// k = rows k0 .. k0+15, transposed on the way: r[0], r[1] for columns
// n0..n0+7, r[2], r[3] for n0+8..n0+15. Used for the products against V, K,
// Q and dO as they are stored.
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], const bf16* tile, int k0, int n0,
                                            int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                           (lane >> 4) * 8);
}

// Copy rows [row0, row0 + rows) x columns [0, DP) of a row-major bf16 matrix
// (row stride rs, in elements) into a shared tile of row stride LD, by
// cp.async; rows past nrows and columns past D are zero-filled and never read
// from device memory (in the packed layout the columns past D are the next
// head's).
template <int DP, int LD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long rs, int row0,
                                          int rows, int nrows, int D) {
  constexpr int kCPR = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kCPR; i += blockDim.x) {
    const int r = i / kCPR, c = (i % kCPR) * 8;
    const int row = row0 + r;
    const bool valid = row < nrows && c < D;
    cp_async16(dst + r * LD + c, valid ? src + (long long)row * rs + c : src, valid);
  }
}

// n f32 values [i0, i0 + n) of a vector into shared memory, zero past len
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int i0, int n,
                                            int len) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool valid = i0 + i < len;
    cp_async4(dst + i, valid ? src + i0 + i : src, valid);
  }
}

// A warp's 16 x (8 NT) f32 accumulator tile (C fragments acc[NT]) for
// columns [col0, col0 + 8 NT), times mul[0] on row g and mul[1] on row g+8,
// rounded to bf16, staged through the warp's own 16 rows of a shared tile
// (stage, row stride LD >= 8 NT) and stored with 16-byte writes: rows [row0,
// row0 + 16) of dst (row stride rs), those < nrows, columns < D.
template <int NT, int LD>
__device__ __forceinline__ void store_tile(bf16* dst, long long rs, const float (&acc)[NT][4],
                                           const float (&mul)[2], bf16* stage, int row0,
                                           int nrows, int col0, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][0] * mul[0], acc[j][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][2] * mul[1], acc[j][3] * mul[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NT; i += 32) {
    const int r = i / NT, c = (i % NT) * 8;
    const int row = row0 + r;
    if (row < nrows && col0 + c < D)
      store_vec8(dst + (long long)row * rs + col0 + c, load_vec8(stage + r * LD + c));
  }
}

}  // namespace e2v

// 3xTF32 on mma.sync.m16n8k8: the f32 products of the f32 attention pair
// (flash_f32.cuh) and of the f32 feed-forward pair (ff_f32.cu).
//
// An f32 product a b is taken on the tensor cores from tf32 parts: each
// element x is split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x -
// big) (big + small = x within 2^-22 relative), and c += a_small b_big +
// a_big b_small + a_big b_big, in that order; a_small b_small (below 2^-22)
// is dropped. One tf32 product alone (a 10-bit mantissa) would be about 1e-3.
// The tensor cores truncate as they accumulate, so a chain of mma runs over
// at most 32 k into fresh accumulators, which f32 adds take into the totals
// (add_tile; tests/test_torch_tf32_split.py emulates both on the CPU).
//
// Fragments (lane = 4 g + t): A (16 x 8) a0 (row g, k t), a1 (g+8, t), a2
// (g, t+4), a3 (g+8, t+4); B (8 x 8, k x n) b0 (k t, col g), b1 (k t+4, col
// g); C (16 x 8) c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8). Tiles are
// row-major f32 with a row stride that is an odd multiple of 16 bytes (4
// floats past a multiple of 32): one 8 x 8 b16 matrix of ldmatrix is then an
// 8 x 4 f32 tile in exactly the A / B fragment layout, and its 8 row
// addresses fall on 8 different bank groups.
#pragma once

#include "flash_tiles.cuh"

namespace e2v {
namespace f32k {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small within 2^-22 relative, both tf32 (the low 13 bits zero).
// big is cvt.rna.tf32(x) in two integer operations (half a tf32 ulp added to
// the magnitude, the low 13 bits cleared): the same bits for every finite x
// and for inf. A NaN x may lose its NaN in big (a payload that carries), but
// small = cvt.rna.tf32(x - big) is then NaN, so the product is NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float4& x, float4& big, float4& small) {
  uint32_t b, s;
  split_tf32(x.x, b, s);
  big.x = __uint_as_float(b), small.x = __uint_as_float(s);
  split_tf32(x.y, b, s);
  big.y = __uint_as_float(b), small.y = __uint_as_float(s);
  split_tf32(x.z, b, s);
  big.z = __uint_as_float(b), small.z = __uint_as_float(s);
  split_tf32(x.w, b, s);
  big.w = __uint_as_float(b), small.w = __uint_as_float(s);
}

// c += a b on tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: a_small b_big, a_big b_small, a_big b_big, in that order
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                     uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// A fragments (big and small) of 16 rows x columns k0 .. k0+7 of a split tile
template <int LD>
__device__ __forceinline__ void load_a32(uint32_t (&ab)[4], uint32_t (&as)[4], const float* xb,
                                         const float* xs, int k0, int lane) {
  const int off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 + (lane >> 4) * 4;
  ldmatrix_x4(ab, xb + off);
  ldmatrix_x4(as, xs + off);
}

// B fragments of two n8 tiles, rows n0 .. n0+15 of a tile taken as the
// columns of B, over k = columns k0 .. k0+7: r[0], r[1] of rows n0 .. n0+7,
// r[2], r[3] of rows n0+8 .. n0+15
template <int LD>
__device__ __forceinline__ void load_b_rows32(uint32_t (&r)[4], const float* x, int n0, int k0,
                                              int lane) {
  ldmatrix_x4(r, x + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 4);
}

// acc += t: a run of fresh accumulators taken into the totals
__device__ __forceinline__ void add_tile(float (&acc)[4], const float (&t)[4]) {
  acc[0] += t[0], acc[1] += t[1], acc[2] += t[2], acc[3] += t[3];
}

}  // namespace f32k
}  // namespace e2v

// flash_f32: the f32 attention kernels, forward (flash_f32.cu) and backward
// (flash_f32_bwd.cu). The f32 counterparts of flash_fwd.cuh / flash_bwd.cuh.
//
// Replaces (JAX package, eeg2video_tpu/ops/attention.py), where it runs on
// f32 operands (its dispatch has no dtype test: :1709, :840):
//   _flash_fwd_packed :1282 (_packed_single_kernel :415, _packed_kernel :487),
//   _flash_dual_fwd_packed :643 (_packed_dual_kernel :566),
//   _flash_bwd_packed :1114 (_packed_dq_kernel :902, _packed_dkv_kernel :957
//   with its dbias :1005-1018, _packed_dqkv_kernel :1021),
//   _flash_attention_dual_bwd :789, and the head-major _flash_fwd :216 /
//   _flash_bwd :269 behind fused_attention :386.
//
// One softmax over one or two KV segments, [K0 | K1], an optional additive
// bias on segment 0, the natural-log row log-sum-exp, and the backward from
// (out, lse): the same function and operand layouts as the bf16 kernels.
// Every operand is addressed as
//   p + (n / m) sb + (n % m) sg + h sh + row sr + d
// for query group n of m per batch element and head h, so one kernel reads
// the packed (., L, H*D) rows (sh = D, sr = H*D) and the head-major
// (B, H, L, D) ones (sh = the head stride, sr = D) in place; K0 / V0 / bias0
// are shared by the m groups of a batch element (sg = 0).
//
// What bounds them on the H100: the products, 4 (forward) and 10 (backward)
// Lq Lkv D operations a head, far above the bytes of the operands. An f32
// product has to keep f32 accuracy, so the least time is 3 tf32 products at
// the tensor cores' dense TF32 rate (494.7 TFLOP/s), not one.
//
// Design: 3xTF32 on mma.sync.m16n8k8 (tf32 operands, f32 accumulators; the
// split, the mma and the A / B fragment loads are in tf32_mma.cuh, shared
// with the f32 feed-forward pair).
//   - Each operand element x is split into big = cvt.rna.tf32(x) and small =
//     cvt.rna.tf32(x - big) (big + small = x within 2^-22 relative), and
//     every product is c += a_small b_big + a_big b_small + a_big b_big, in
//     that order; a_small b_small (below 2^-22) is dropped. That keeps about
//     2^-21 relative per product; one tf32 product (a 10-bit mantissa) would
//     be about 1e-3 and is not used anywhere.
//   - Where the split is made: an operand tile that every warp of the block
//     reads (the streamed K / V, or Q / dO, tiles, and the block's own rows)
//     is split once, in shared memory, when it lands: big and small tiles
//     side by side (2x the bytes). Splitting fragments in registers instead
//     would repeat the split (three ALU operations an element) in each of
//     the 4 or 8 warps that read the tile. Only what lives in one warp's
//     registers, P and dS, is split there, once per element. Measured on the
//     H100 (the forward at (2,4,2304,320)x[2304|2304]): the split passes of
//     K and V take about 11% of the kernel (2.28 ms, and 2.02 ms with the
//     products reading the landed tiles unsplit).
//   - D runs in exact k8 steps (D % 8 == 0): 5 at D = 40, 10 at 80, 20 at
//     160. The kernels are instantiated at DP = D up to 48 and at 64, 80, 96,
//     128 and 160 above it; a D between them is padded with zeros in shared
//     memory only (never read from device memory, never written).
//   - Fragments. Tiles are row-major f32 with a row stride of DP + 4 floats,
//     an odd multiple of 16 bytes: one 8 x 8 b16 matrix of ldmatrix is an
//     8 x 4 f32 tile in exactly the tf32 A / B fragment layout, and its 8 row
//     addresses fall on 8 different bank groups. A fragments (Q, dO; K, V in
//     the dkv pass) and the B fragments whose k runs along D (K in Q K^T, V
//     in dO V^T, Q and dO in the dkv pass) come by ldmatrix.x4.
//   - The C fragment of S (P, dS) is the A fragment of the next product with
//     no shuffle: a C fragment holds columns 2t and 2t+1 of a quad, the A
//     fragment of m16n8k8 holds k = t and t+4, so k = t is read as key 2t
//     and k = t+4 as key 2t+1, and the B fragment (V, K, dO, Q as stored:
//     k along the rows) loads the same rows 2t and 2t+1. Its columns are
//     taken in pairs of n8 tiles, tile j as columns 2g and tile j+1 as 2g+1
//     of the pair's 16, so each B register pair is one 8-byte load (the row
//     stride makes the 32 loads of a warp free of bank conflicts); a lane
//     then holds four consecutive output columns 4t .. 4t+3 of its rows,
//     written with one 16-byte store.
//   - Accumulation: the mma chain of one product runs over a chunk of at
//     most 32 keys (or queries) into fresh accumulators, added to O, dQ, dK
//     or dV by f32 adds; the tensor cores truncate as they accumulate, and
//     chains over a whole sequence land about 10x further from the f32
//     result.
//   - Pipeline: a landing tile (cp.async, 16 bytes a thread where every row
//     is 16-byte aligned, else 4) and a split tile. At the top of tile t the
//     block waits for tile t's copies, splits it into the split tiles (one
//     barrier before, one after), issues tile t+1's copies into the landing
//     tiles, and runs tile t's products while they are in flight. K and V
//     (or Q and dO) are one copy group: the split needs both, and the copies
//     were issued a whole tile of products earlier.
//   - A block is 8, 4 or 2 warps of 16 rows (pick_warps: the most warps
//     resident on the card that shared memory allows), streamed tiles of 64
//     rows (32 or 16 at larger D); S, the row max and sum, O and dQ / dK / dV
//     stay in registers; a row's max and sum cost 2 quad shuffles.
// The forward keeps the running row max and sum (exp2f on scores scaled to
// base 2, the lse written in natural log); the backward is two passes with
// no atomics: the dq pass (which also writes delta = rowsum(dO * O)) and the
// dkv pass, whose segment-0 blocks walk every group of their batch element
// in order, so dK0 / dV0 are summed over the m frames in a fixed order, and
// write dbias0 per head; a last pass adds the heads in order. The same bits
// on every run.
#pragma once

#include "tf32_mma.cuh"

namespace e2v {
namespace f32k {

constexpr int kMaxD = 160;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use (227 KB)

struct Tens {
  float* p;
  long long sb, sg, sh, sr;  // batch, group, head and row strides, in elements
  __device__ __forceinline__ float* at(int n, int m, int h) const {
    return p + (long long)(n / m) * sb + (long long)(n % m) * sg + (long long)h * sh;
  }
};

struct AttnArgs {
  Tens q, k0, v0, k1, v1, o, dout, dq, dk0, dv0, dk1, dv1;
  const float* bias;   // (b, L0) or null
  float* lse;          // (N, H, Lq)
  float* delta;        // (N, H, Lq), written by the dq pass
  float* dbias_part;   // (b, H, L0) or null
  float* dbias;        // (b, L0) or null
  int N, m, Lq, L0, L1, H, D;
  int vec;             // every operand row starts 16-byte aligned: 16-byte copies and stores
  float scale;
};

// row stride of a tile, in floats: an odd multiple of 16 bytes (D % 8 == 0)
template <int DP>
__host__ __device__ constexpr int tile_ld() {
  return DP + 4;
}

// streamed rows a tile: the K / V tiles of the forward, of the dq pass, and
// the Q / dO tiles of the dkv pass
template <int DP>
__host__ __device__ constexpr int fwd_kv_rows() {
  return DP <= 80 ? 64 : 32;
}
template <int DP>
__host__ __device__ constexpr int bwd_tile_rows() {
  return DP <= 48 ? 64 : DP <= 96 ? 32 : 16;
}

// Dispatch on DP: D itself up to 48, else D rounded up to 64, 80, 96, 128 or
// 160 (D % 8 == 0, D <= 160)
template <template <int> class Launch, typename... A>
int dispatch_dp(int D, A... args) {
  switch (D / 8) {
    case 1: return Launch<8>::run(args...);
    case 2: return Launch<16>::run(args...);
    case 3: return Launch<24>::run(args...);
    case 4: return Launch<32>::run(args...);
    case 5: return Launch<40>::run(args...);
    case 6: return Launch<48>::run(args...);
    case 7: case 8: return Launch<64>::run(args...);
    case 9: case 10: return Launch<80>::run(args...);
    case 11: case 12: return Launch<96>::run(args...);
    case 13: case 14: case 15: case 16: return Launch<128>::run(args...);
    case 17: case 18: case 19: case 20: return Launch<160>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Warps a block (16 rows each) for a pass of `kernel` over `rows` rows in
// `other` grid cells; smem(w) is its dynamic shared memory at w warps. Of 8,
// 4 and 2 warps that fit, the one with the most warps in flight on the card
// (warps a block x blocks resident at once), then the one that spreads over
// more SMs, then the larger. Sets the kernel's shared-memory cap; returns 0
// if none fits or the runtime refused a call.
template <class Kernel, class Smem>
int pick_warps(Kernel kernel, Smem smem, int rows, int other) {
  int best = 0;
  long long best_warps = -1, best_sms = -1;
  bool capped = false;
  for (int w = 8; w >= 2; w /= 2) {
    const size_t bytes = smem(w);
    if (bytes > kMaxSmem) continue;
    if (!capped) {  // the largest that fits comes first: the cap covers the rest
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes) != cudaSuccess)
        return 0;
      capped = true;
    }
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, bytes) !=
            cudaSuccess || per_sm == 0)
      continue;
    const long long blocks = (long long)((rows + 16 * w - 1) / (16 * w)) * other;
    const long long in_flight = blocks < 132LL * per_sm ? blocks : 132LL * per_sm;
    const long long warps = w * in_flight, sms = blocks < 132 ? blocks : 132;
    if (warps > best_warps || (warps == best_warps && sms > best_sms)) {
      best = w;
      best_warps = warps;
      best_sms = sms;
    }
  }
  return best;
}

// --- tiles -------------------------------------------------------------------

// Rows [row0, row0 + rows) x columns [0, DP) of an operand (row r at src +
// r rs) into a landing tile, by cp.async; rows past nrows and columns past D
// are zero-filled and never read from device memory
template <int DP>
__device__ __forceinline__ void land_rows(float* dst, const float* src, long long rs, int row0,
                                          int rows, int nrows, int D, bool vec) {
  constexpr int LD = tile_ld<DP>();
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = threadIdx.x; i < rows * C4; i += blockDim.x) {
      const int r = i / C4, c = (i % C4) * 4, row = row0 + r;
      const bool valid = row < nrows && c < D;
      cp_async16(dst + r * LD + c, valid ? src + (long long)row * rs + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP, row = row0 + r;
      const bool valid = row < nrows && c < D;
      cp_async4(dst + r * LD + c, valid ? src + (long long)row * rs + c : src, valid);
    }
  }
}

// The split of a landed tile (rows x DP) into its big and small tiles; raw
// may be small (in place: each element is read and written by one thread).
// first / step: the threads taking part (the block, or one warp's lanes).
template <int DP>
__device__ __forceinline__ void split_rows(float* big, float* small, const float* raw, int rows,
                                           int first, int step) {
  constexpr int LD = tile_ld<DP>(), C4 = DP / 4;
  for (int i = first; i < rows * C4; i += step) {
    const int off = (i / C4) * LD + (i % C4) * 4;
    float4 b, s;
    split4(*reinterpret_cast<const float4*>(raw + off), b, s);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = s;
  }
}

// s[j] (16 rows x 8 NS columns, C fragments) += A B^T over the DP columns:
// A the warp's 16 rows of a split tile (ab, as), B rows n0 .. n0 + 8 NS of
// another (bb, bs)
template <int DP, int NS>
__device__ __forceinline__ void mma_rows(float (&s)[NS][4], const float* ab_, const float* as_,
                                         const float* bb, const float* bs, int n0, int lane) {
  constexpr int LD = tile_ld<DP>();
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ab[4], as[4];
    load_a32<LD>(ab, as, ab_, as_, kk * 8, lane);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t rb[4], rs[4];
      load_b_rows32<LD>(rb, bb, n0 + np * 16, kk * 8, lane);
      load_b_rows32<LD>(rs, bs, n0 + np * 16, kk * 8, lane);
      mma3(s[2 * np], ab, as, rb[0], rb[1], rs[0], rs[1]);
      mma3(s[2 * np + 1], ab, as, rb[2], rb[3], rs[2], rs[3]);
    }
  }
}

// acc (16 rows x DP, the paired layout below) += C X: C given as the C
// fragments c[KS] of a previous product (16 rows x 8 KS columns), split
// here, X rows r0 .. r0 + 8 KS of a split tile (xb, xs) taken as stored (k
// along its rows). The A fragment of step kk reads column 2t of c[kk] as
// k = t and 2t+1 as k = t+4, and B reads rows 2t and 2t+1 to match. Columns
// come in pairs of n8 tiles: acc[2p] holds columns 16p + 2n, acc[2p+1]
// columns 16p + 2n + 1 (n the tile's column); an odd last tile is plain.
// C X is summed over its 8 KS rows in fresh accumulators, added to acc by
// f32 adds: the tensor cores' accumulation truncates, and one chain of mma
// over a whole key or query sequence lands about 10x further from the f32
// result (measured on the H100, PERF.md §6). Where 4 NT registers of fresh
// accumulators cost more than the split A fragments of every step, the
// pairs go outside the steps; the sums, and so the bits, are the same.
template <int LD>
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], uint32_t (&s)[4], const float* xb,
                                            const float* xs, int off) {
  const float2 blo = *reinterpret_cast<const float2*>(xb + off);
  const float2 bhi = *reinterpret_cast<const float2*>(xb + off + LD);
  const float2 slo = *reinterpret_cast<const float2*>(xs + off);
  const float2 shi = *reinterpret_cast<const float2*>(xs + off + LD);
  b[0] = __float_as_uint(blo.x), b[1] = __float_as_uint(bhi.x);  // tile 2p: k = t, t+4
  b[2] = __float_as_uint(blo.y), b[3] = __float_as_uint(bhi.y);  // tile 2p+1
  s[0] = __float_as_uint(slo.x), s[1] = __float_as_uint(shi.x);
  s[2] = __float_as_uint(slo.y), s[3] = __float_as_uint(shi.y);
}

__device__ __forceinline__ void split_c(uint32_t (&ab)[4], uint32_t (&as)[4], const float (&c)[4]) {
  split_tf32(c[0], ab[0], as[0]);  // row g, k = t: column 2t
  split_tf32(c[2], ab[1], as[1]);  // row g+8, k = t
  split_tf32(c[1], ab[2], as[2]);  // row g, k = t+4: column 2t+1
  split_tf32(c[3], ab[3], as[3]);  // row g+8, k = t+4
}

template <int DP, int KS>
__device__ __forceinline__ void mma_c_by_cols(float (&acc)[DP / 8][4], const float (&c)[KS][4],
                                              const float* xb, const float* xs, int r0,
                                              int lane) {
  constexpr int LD = tile_ld<DP>(), NT = DP / 8;
  const int base = (r0 + 2 * (lane & 3)) * LD, col = lane >> 2;
  if constexpr (2 * KS < NT) {  // pairs outside: fresh accumulators of 2 tiles
    uint32_t ab[KS][4], as[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) split_c(ab[kk], as[kk], c[kk]);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4], s[4];
        load_b_pair<LD>(b, s, xb, xs, base + kk * 8 * LD + p * 16 + 2 * col);
        mma3(t0, ab[kk], as[kk], b[0], b[1], s[0], s[1]);
        mma3(t1, ab[kk], as[kk], b[2], b[3], s[2], s[3]);
      }
      add_tile(acc[2 * p], t0);
      add_tile(acc[2 * p + 1], t1);
    }
    if (NT % 2 == 1) {
      float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int o = base + kk * 8 * LD + (NT - 1) * 8 + col;
        mma3(t0, ab[kk], as[kk], __float_as_uint(xb[o]), __float_as_uint(xb[o + LD]),
             __float_as_uint(xs[o]), __float_as_uint(xs[o + LD]));
      }
      add_tile(acc[NT - 1], t0);
    }
  } else {  // steps outside: a fresh accumulator of all NT tiles
    float t[NT][4];
    zero(t);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      split_c(ab, as, c[kk]);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4], s[4];
        load_b_pair<LD>(b, s, xb, xs, base + kk * 8 * LD + p * 16 + 2 * col);
        mma3(t[2 * p], ab, as, b[0], b[1], s[0], s[1]);
        mma3(t[2 * p + 1], ab, as, b[2], b[3], s[2], s[3]);
      }
      if (NT % 2 == 1) {
        const int o = base + kk * 8 * LD + (NT - 1) * 8 + col;
        mma3(t[NT - 1], ab, as, __float_as_uint(xb[o]), __float_as_uint(xb[o + LD]),
             __float_as_uint(xs[o]), __float_as_uint(xs[o + LD]));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) add_tile(acc[j], t[j]);
  }
}

// Rows row0 + g and row0 + g + 8 of a warp's accumulator (16 x DP in the
// paired layout of mma_c_by_cols) times mul[0] / mul[1] into dst (row stride
// rs): rows < nrows, columns < D; 16-byte stores with vec
template <int DP>
__device__ __forceinline__ void store_rows(float* dst, long long rs, const float (&acc)[DP / 8][4],
                                           const float (&mul)[2], int row0, int nrows, int D,
                                           bool vec, int lane) {
  constexpr int NT = DP / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nrows) continue;
    float* p = dst + (long long)row * rs;
    const float f = mul[r];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const int c = 16 * j + 4 * t;
      if (c >= D) continue;
      const float4 v = make_float4(acc[2 * j][2 * r] * f, acc[2 * j + 1][2 * r] * f,
                                   acc[2 * j][2 * r + 1] * f, acc[2 * j + 1][2 * r + 1] * f);
      if (vec) {
        *reinterpret_cast<float4*>(p + c) = v;
      } else {
        p[c] = v.x, p[c + 1] = v.y, p[c + 2] = v.z, p[c + 3] = v.w;
      }
    }
    if (NT % 2 == 1) {
      const int c = 8 * (NT - 1) + 2 * t;
      if (c < D) {
        p[c] = acc[NT - 1][2 * r] * f;
        p[c + 1] = acc[NT - 1][2 * r + 1] * f;
      }
    }
  }
}

// Tens from 4 strides; the pointer may be null
inline Tens tens(const void* p, const long long* s) {
  return Tens{const_cast<float*>(static_cast<const float*>(p)), s[0], s[1], s[2], s[3]};
}

// 16-byte rows: the pointer and all four strides of every present operand
inline bool rows16(const Tens* const* ts, int n) {
  for (int i = 0; i < n; ++i) {
    const Tens& t = *ts[i];
    if (t.p == nullptr) continue;
    if (reinterpret_cast<uintptr_t>(t.p) % 16 != 0 || t.sb % 4 != 0 || t.sg % 4 != 0 ||
        t.sh % 4 != 0 || t.sr % 4 != 0)
      return false;
  }
  return true;
}

}  // namespace f32k
}  // namespace e2v

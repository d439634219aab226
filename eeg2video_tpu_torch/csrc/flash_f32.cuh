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
// Design: a block owns 64 query rows (the dkv pass: 64 key rows) of one head
// and one group; 256 threads as 16 x 16, each 4 rows x (D / 16 or 64 / 16)
// columns; Q, K, V, dO tiles in shared memory as f32 rows padded to DP, a
// multiple of 16 (zeros past D), row stride DP + 1. The forward keeps O and
// the running row max and sum in registers (online softmax, expf); the
// backward is two passes with no atomics: the dq pass (which also writes
// delta = rowsum(dO * O)) and the dkv pass, whose segment-0 blocks walk every
// group of their batch element in order, so dK0 / dV0 are summed over the m
// frames in a fixed order, and write dbias0 per head; a last pass adds the
// heads in order. The same bits on every run.
#pragma once

#include "f32_tiles.cuh"

namespace e2v {
namespace f32k {

constexpr int kTile = 64;          // query and key rows of a tile
constexpr int kLS = kTile + 1;     // row stride of the 64 x 64 probability tiles
constexpr int kMaxD = 160;

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
  float scale;
};

template <int DP>
constexpr size_t fwd_smem() {
  return ((size_t)3 * kTile * (DP + 1) + (size_t)kTile * kLS) * sizeof(float);
}

template <int DP>
constexpr size_t dq_smem() {
  return ((size_t)4 * kTile * (DP + 1) + (size_t)kTile * kLS) * sizeof(float);
}

template <int DP>
constexpr size_t dkv_smem() {
  return ((size_t)4 * kTile * (DP + 1) + (size_t)2 * kTile * kLS + 2 * kTile) * sizeof(float);
}

// Dispatch on DP = D rounded up to a multiple of 16 (D % 8 == 0, D <= 160)
template <template <int> class Launch, typename... A>
int dispatch_dp(int D, A... args) {
  switch ((D + 15) / 16) {
    case 1: return Launch<16>::run(args...);
    case 2: return Launch<32>::run(args...);
    case 3: return Launch<48>::run(args...);
    case 4: return Launch<64>::run(args...);
    case 5: return Launch<80>::run(args...);
    case 6: return Launch<96>::run(args...);
    case 7: return Launch<112>::run(args...);
    case 8: return Launch<128>::run(args...);
    case 9: return Launch<144>::run(args...);
    case 10: return Launch<160>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Tens from 4 strides; the pointer may be null
inline Tens tens(const void* p, const long long* s) {
  return Tens{const_cast<float*>(static_cast<const float*>(p)), s[0], s[1], s[2], s[3]};
}

}  // namespace f32k
}  // namespace e2v

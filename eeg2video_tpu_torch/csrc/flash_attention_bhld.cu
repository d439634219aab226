// fused_attention_fwd / fused_attention_bwd: attention over head-major
// (B, H, L, D) operands, forward (optional lse) and backward.
//
// Replaces (JAX package, eeg2video_tpu/ops/attention.py):
//   _flash_kernel (:75), launched by _flash_fwd (:216, call :235), and
//   _flash_dq_kernel (:118) / _flash_dkv_kernel (:147), launched by
//   _flash_bwd (:269, calls :299 and :333): the (B, H, L, D) flash attention
//   behind fused_attention (:386).
//
// Computes softmax(scale q k^T) v per (b, h), q (B, H, Lq, D), k/v
// (B, H, Lkv, D), no bias; the backward takes (q, k, v, out, lse, dout) and
// returns dq, dk, dv with delta = rowsum(dout * out) formed in its dq pass.
//
// The kernels are those of the packed op (flash_fwd.cuh, flash_bwd.cuh)
// instantiated for the head-major layout: the tiles, the online softmax and
// the two-pass backward do not depend on where a head's rows lie, only the
// addressing does. The operands are read in place: head h of batch element b
// starts at b * batch stride + h * head stride and a row is D contiguous
// values (80 bytes at D = 40, so rows stay 16-byte aligned for the vector
// copies when D % 8 == 0). The TPU wrapper pads D to 128 in HBM (:223-225);
// here D is padded to a multiple of 16 in shared memory only.
// What bounds it on the H100: as the packed op, the products and, at D = 40,
// the softmax's exponentials and the shared-memory reads of the operand
// tiles, not HBM. The instantiations are compiled in flash_fwd_d*.cu and
// flash_bwd_d*.cu; this file only dispatches.
#include "flash_bwd.cuh"
#include "flash_fwd.cuh"

// Strides are in elements: *_sb the batch stride, *_sh the head stride; every
// row is head_dim contiguous bf16 values. lse (B, H, Lq) f32 may be null.
// Returns the CUDA launch status.
extern "C" int e2v_fused_attention_fwd(const void* q, long long q_sb, long long q_sh,
                                       const void* k, long long k_sb, long long k_sh,
                                       const void* v, long long v_sb, long long v_sh,
                                       void* out, long long o_sb, long long o_sh, int batch,
                                       int heads, int lq, int lkv, int head_dim, float scale,
                                       void* lse, void* stream) {
  using namespace e2v;
  AttnArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.q_so = q_sb;
  a.q_hs = q_sh;
  a.k0 = static_cast<const bf16*>(k);
  a.k0_so = k_sb;
  a.k_hs = k_sh;
  a.v0 = static_cast<const bf16*>(v);
  a.v0_so = v_sb;
  a.v_hs = v_sh;
  a.out = static_cast<bf16*>(out);
  a.o_so = o_sb;
  a.o_hs = o_sh;
  a.lse = static_cast<float*>(lse);
  a.m = 1;
  a.lq = lq;
  a.lkv0 = lkv;
  a.head_dim = head_dim;
  a.hd = heads * head_dim;
  a.scale_log2 = scale * kLog2e;
  return dispatch_flash<true>(a, heads, batch, stream);
}

// ptrs: q, k, v, dout, out, lse, delta, dq, dk, dv (delta: a (B, H, Lq) f32
// scratch; dq, dk, dv contiguous (B, H, L, D)). strides, in elements: batch
// and head stride of q, k, v, dout, out, in that order. dims: batch, heads,
// lq, lkv, head_dim. Returns the CUDA launch status.
extern "C" int e2v_fused_attention_bwd(void* const* ptrs, const long long* strides,
                                       const int* dims, float scale, void* stream) {
  using namespace e2v;
  BwdArgs a = {};
  a.q = static_cast<const bf16*>(ptrs[0]);
  a.k0 = static_cast<const bf16*>(ptrs[1]);
  a.v0 = static_cast<const bf16*>(ptrs[2]);
  a.dout = static_cast<const bf16*>(ptrs[3]);
  a.out = static_cast<const bf16*>(ptrs[4]);
  a.lse = static_cast<const float*>(ptrs[5]);
  a.delta = static_cast<float*>(ptrs[6]);
  a.dq = static_cast<bf16*>(ptrs[7]);
  a.dk0 = static_cast<bf16*>(ptrs[8]);
  a.dv0 = static_cast<bf16*>(ptrs[9]);
  a.q_so = strides[0];
  a.q_hs = strides[1];
  a.k0_so = strides[2];
  a.k_hs = strides[3];
  a.v0_so = strides[4];
  a.v_hs = strides[5];
  a.do_so = strides[6];
  a.do_hs = strides[7];
  a.o_so = strides[8];
  a.o_hs = strides[9];
  const int batch = dims[0];
  a.heads = dims[1];
  a.m = 1;
  a.lq = dims[2];
  a.lkv0 = dims[3];
  a.head_dim = dims[4];
  a.hd = a.heads * a.head_dim;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return dispatch_bwd<true>(a, batch, static_cast<cudaStream_t>(stream));
}

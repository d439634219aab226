// flash_attention_bwd: backward of the packed multi-head attention over one
// or two KV segments (flash_attention.cu), with the optional gradient of
// bias0. The kernels are flash_bwd.cuh, instantiated here for the packed
// (., L, H*D) layout.
//
// Replaces (JAX package, eeg2video_tpu/ops/attention.py):
//   _packed_dqkv_kernel (:1021), the combined backward _flash_bwd_packed
//   (:1114) launches for unbiased attention; _packed_dq_kernel (:902) and
//   _packed_dkv_kernel (:957), the same gradients as split passes, with the
//   bias in the score recompute and the dbias output of the biased variant
//   (:1005-1007, :1017-1018, launched at :1253-1275); and the two-segment
//   backward _flash_attention_dual_bwd (:789), which concatenates
//   [K0 | K_prev] and sums dk0/dv0 (and dbias0) over the m frames afterwards.
#include "flash_bwd.cuh"

namespace e2v {
namespace {

// dbias0[b, col] = the H per-head partials of the segment-0 dkv pass, added
// in head order (a fixed order: same bits every run)
__global__ void flash_bwd_dbias_kernel(const float* part, float* dbias, int heads, int lkv,
                                       int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / lkv, col = i % lkv;
  float s = 0.0f;
  for (int h = 0; h < heads; ++h) s += part[((long long)b * heads + h) * lkv + col];
  dbias[i] = s;
}

}  // namespace
}  // namespace e2v

// ptrs: q, k0, v0, k1, v1, dout, out, lse, bias0, delta, dq, dk0, dv0, dk1,
// dv1, dbias_part, dbias (k1, v1, dk1, dv1 and bias0 may be null; dbias_part
// (N / m, H, Lkv0) and dbias (N / m, Lkv0), both f32, are null unless the
// gradient of bias0 is wanted). strides, in elements: q_so, q_si, do_so,
// do_si, o_so, o_si, k0_so, v0_so, k1_so, k1_si, v1_so, v1_si. dims: n_total,
// m, lq, lkv0, lkv1, heads, head_dim. Every row is heads * head_dim
// contiguous bf16 values; the gradient outputs are contiguous. Returns the
// CUDA launch status.
extern "C" int e2v_flash_attention_bwd(void* const* ptrs, const long long* strides,
                                       const int* dims, float scale, void* stream) {
  using namespace e2v;
  BwdArgs a = {};
  a.q = static_cast<const bf16*>(ptrs[0]);
  a.k0 = static_cast<const bf16*>(ptrs[1]);
  a.v0 = static_cast<const bf16*>(ptrs[2]);
  a.k1 = static_cast<const bf16*>(ptrs[3]);
  a.v1 = static_cast<const bf16*>(ptrs[4]);
  a.dout = static_cast<const bf16*>(ptrs[5]);
  a.out = static_cast<const bf16*>(ptrs[6]);
  a.lse = static_cast<const float*>(ptrs[7]);
  a.bias0 = static_cast<const float*>(ptrs[8]);
  a.delta = static_cast<float*>(ptrs[9]);
  a.dq = static_cast<bf16*>(ptrs[10]);
  a.dk0 = static_cast<bf16*>(ptrs[11]);
  a.dv0 = static_cast<bf16*>(ptrs[12]);
  a.dk1 = static_cast<bf16*>(ptrs[13]);
  a.dv1 = static_cast<bf16*>(ptrs[14]);
  a.dbias_part = static_cast<float*>(ptrs[15]);
  float* dbias = static_cast<float*>(ptrs[16]);
  a.q_so = strides[0];
  a.q_si = strides[1];
  a.do_so = strides[2];
  a.do_si = strides[3];
  a.o_so = strides[4];
  a.o_si = strides[5];
  a.k0_so = strides[6];
  a.v0_so = strides[7];
  a.k1_so = strides[8];
  a.k1_si = strides[9];
  a.v1_so = strides[10];
  a.v1_si = strides[11];
  const int n_total = dims[0];
  a.m = dims[1];
  a.lq = dims[2];
  a.lkv0 = dims[3];
  a.lkv1 = dims[4];
  a.heads = dims[5];
  a.head_dim = dims[6];
  a.hd = a.heads * a.head_dim;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch_bwd<false>(a, n_total, s);
  if (rc != 0 || a.dbias_part == nullptr) return rc;
  const int total = n_total / a.m * a.lkv0;
  flash_bwd_dbias_kernel<<<(total + 255) / 256, 256, 0, s>>>(a.dbias_part, dbias, a.heads,
                                                             a.lkv0, total);
  return (int)cudaGetLastError();
}

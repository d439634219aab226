// flash_attention_fwd: packed multi-head attention forward over one or two
// KV segments. The kernel is flash_fwd.cuh, instantiated here for the packed
// (., L, H*D) layout.
//
// Replaces (JAX package, eeg2video_tpu/ops/attention.py):
//   _packed_single_kernel (:415), the whole-KV packed forward, and
//   _packed_dual_kernel (:566), the sparse-causal [K0 | K_prev] forward.
//   It also computes what _packed_kernel (:487) computes (online softmax over
//   KV tiles); that body is not reached by the generation path.
#include "flash_fwd.cuh"

// Strides are in elements; every row is hd contiguous bf16 values. k1/v1,
// bias0 and lse may be null. Returns the CUDA launch status.
extern "C" int e2v_flash_attention_fwd(
    const void* q, long long q_so, long long q_si, const void* k0, long long k0_so,
    const void* v0, long long v0_so, const void* k1, long long k1_so, long long k1_si,
    const void* v1, long long v1_so, long long v1_si, const void* bias0, void* out,
    long long o_so, long long o_si, int n_total, int m, int lq, int lkv0, int lkv1,
    int heads, int head_dim, float scale, void* lse, void* stream) {
  using namespace e2v;
  AttnArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.q_so = q_so;
  a.q_si = q_si;
  a.k0 = static_cast<const bf16*>(k0);
  a.k0_so = k0_so;
  a.v0 = static_cast<const bf16*>(v0);
  a.v0_so = v0_so;
  a.k1 = static_cast<const bf16*>(k1);
  a.k1_so = k1_so;
  a.k1_si = k1_si;
  a.v1 = static_cast<const bf16*>(v1);
  a.v1_so = v1_so;
  a.v1_si = v1_si;
  a.bias0 = static_cast<const float*>(bias0);
  a.out = static_cast<bf16*>(out);
  a.o_so = o_so;
  a.o_si = o_si;
  a.lse = static_cast<float*>(lse);
  a.m = m;
  a.lq = lq;
  a.lkv0 = lkv0;
  a.lkv1 = lkv1;
  a.head_dim = head_dim;
  a.hd = heads * head_dim;
  a.scale_log2 = scale * kLog2e;
  return dispatch_flash<false>(a, heads, n_total, stream);
}

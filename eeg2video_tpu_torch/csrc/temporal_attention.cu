// The forward of temporal attention: the entry points of its bf16 and f32
// instantiations. The kernels, both routes and their design are in
// temporal_attention.cuh; the backward's entries in temporal_attention_bwd.cu
// (one file each, so that the two sets of instantiations build in parallel).
#include "temporal_attention.cuh"

// q, k, v, out (B, F, L, heads * head_dim) bf16 sharing the element strides
// sb (batch) and sf (frame), rows contiguous. On the staged route
// (temporal_plan.cuh) every pointer and stride is 16-byte aligned. Returns
// the CUDA launch status, or temporal_plan::kDoesNotFit, before any launch,
// for a call whose (token, head) does not fit a block's shared memory.
extern "C" int e2v_temporal_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                          long long sb, long long sf, int B, int F, int L,
                                          int heads, int head_dim, float scale, void* stream) {
  const void* in[3] = {q, k, v};
  void* outs[1] = {out};
  return e2v::temporal_run<2, false>(in, outs, sb, sf, B, F, L, heads, head_dim, scale, stream);
}

// The f32 counterpart: the same arguments, f32 tensors.
extern "C" int e2v_temporal_attention_fwd_f32(const void* q, const void* k, const void* v,
                                              void* out, long long sb, long long sf, int B,
                                              int F, int L, int heads, int head_dim,
                                              float scale, void* stream) {
  const void* in[3] = {q, k, v};
  void* outs[1] = {out};
  return e2v::temporal_run<4, false>(in, outs, sb, sf, B, F, L, heads, head_dim, scale, stream);
}

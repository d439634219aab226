// The backward of temporal attention: the entry points of its bf16 and f32
// instantiations (kernels and design in temporal_attention.cuh).
#include "temporal_attention.cuh"

// As e2v_temporal_attention_fwd, plus dout in and dq, dk, dv out, all with
// the same strides.
extern "C" int e2v_temporal_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          long long sb, long long sf, int B, int F, int L,
                                          int heads, int head_dim, float scale, void* stream) {
  const void* in[4] = {q, k, v, dout};
  void* outs[3] = {dq, dk, dv};
  return e2v::temporal_run<2, true>(in, outs, sb, sf, B, F, L, heads, head_dim, scale, stream);
}

// The f32 counterpart: the same arguments, f32 tensors.
extern "C" int e2v_temporal_attention_bwd_f32(const void* q, const void* k, const void* v,
                                              const void* dout, void* dq, void* dk, void* dv,
                                              long long sb, long long sf, int B, int F, int L,
                                              int heads, int head_dim, float scale,
                                              void* stream) {
  const void* in[4] = {q, k, v, dout};
  void* outs[3] = {dq, dk, dv};
  return e2v::temporal_run<4, true>(in, outs, sb, sf, B, F, L, heads, head_dim, scale, stream);
}
